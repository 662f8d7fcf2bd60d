// The wavefront's cluster-signature sort key for Hopper (sm_90a).
//
// Replaces _sort_key (radish_pt_tpu/scene/device_scene.py), which the JAX
// package computes in XLA with no Pallas body: an [N, C] slab test of every
// ray against the scene's super-cluster boxes (the cull clusters paired
// until C <= 256), then per ray the first box it can reach, the second,
// and how many.  intersect_sorted, test_occlusion_sorted and the sliced
// bounce loop sort their rays on this key, so that the lanes of one warp
// want the same clusters; a dead lane's key carries bit 24 and sorts last.
//
// Arithmetic: the plain version's, operation for operation —
//   inv = 1 / (|d| > 1e-12 ? d : 1e-12)  (IEEE division),
//   a, b = (box - o) * inv               (__fsub_rn, then __fmul_rn: never
//                                         contracted into an FMA),
//   tn = max(-3.4e38, min(a, b)), tf = min(3.4e38, max(a, b)) per axis,
//   hit = tf >= max(tn, 0) [and tn < tmax],
// with min and max that propagate NaN as torch.minimum / torch.maximum do,
// so the key equals the plain version's as an integer on every lane, NaN
// rays included.
//
// Key: (first (8 bits) << 14) | (second, absolute id (8 bits) << 6) |
// count clamped to 63; the band engine's count-major form is (count << 16)
// | (first << 8) | second.  A missing first or second is C + 1, clamped to
// 255; with C = 256 that is real cluster 255, so there a ray that reaches
// no box also carries bit 22 (miss_extra) and sorts after every hit.
//
// Bound on the card: f32 issue.  A (ray, box) pair is ~26 operations (6
// differences, 6 products, 6 min / max of the slab ends, 6 updates of tn
// and tf, max(tn, 0), the comparison; a range adds one) against ~53 bytes
// a ray, so a slab test of C boxes is operation-bound above C ~ 2.  The
// design until this one issued ~70 instructions a pair: one ray a thread
// and one box a step (six scalar shared loads), each min / max written as
// a compare, a NaN test and a select, and a branch to update first,
// second and count.  This one:
// 1. The finite path, warp-uniform.  NaN enters the slab test only
//    through its products.  inv is always finite (|inv| <= 1e12) and is 0
//    only where d is infinite; so where the origin is finite and inv is
//    not 0, box - o is finite or +-inf (overflow) for a finite box, and
//    (box - o) * inv is never NaN (no inf * 0, no inf - inf).  Without a
//    NaN, fminf / fmaxf are torch.minimum / maximum up to the sign of a
//    zero, and no comparison after them (>=, <) sees that sign: the same
//    verdicts, bit for bit the same key.  The boxes are staged once a
//    block and the block notes whether all are finite
//    (__syncthreads_and); a warp whose rays all have a finite origin and
//    a non-zero inv takes the slab test with fminf / fmaxf, one
//    instruction each; any other warp takes the NaN rule.  The choice is
//    per warp (__all_sync), so no lane diverges on it.
// 2. One box is two shared loads, a float4 (lo.xyz, hi.x) and a float2
//    (hi.yz), read by every thread as a broadcast; each thread holds
//    KEY_RAYS rays, so one box's loads serve KEY_RAYS independent chains.
// 3. No branch a box: a hit sets the box's bit in a 32-box word (one
//    predicated OR); every 32 boxes the word gives the count (popc) and,
//    in box order, the first and second hit (ffs), so they stay the
//    lowest ids.
// 4. One block a chunk of KEY_THREADS x KEY_RAYS rays (128 x 2), which
//    stages the boxes once.  tune key held it against a grid of the
//    blocks the card holds at once looping over chunks (with or without
//    balancing the last chunks across threads): as fast or 2-8% faster,
//    with no host query; 1 and 4 rays a thread, 64 and 256 threads a
//    block within -7% to +10% of it.
//
// Launched on the caller's stream; the C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef KEY_RAYS
#define KEY_RAYS 2  // rays a thread
#endif
#ifndef KEY_THREADS
#define KEY_THREADS 128  // threads a block
#endif

namespace {

constexpr int kRays = KEY_RAYS;
constexpr int kThreads = KEY_THREADS;
constexpr int kChunk = kRays * kThreads;  // a block's rays
constexpr int kMaxBoxes = 256;
constexpr int kDeadBit = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRays >= 1 && kRays <= 8, "KEY_RAYS: 1 to 8");
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "KEY_THREADS: whole warps, at most 1024");

// min / max that return NaN when either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// One (ray, box) of the slab test: true where the ray reaches the box.
// kNan: with the NaN rule; else fminf / fmaxf (the finite path).
template <bool kNan, bool kRanged>
__device__ __forceinline__ bool slab_hit(const float4& a, const float2& b, const float* o,
                                         const float* inv, float tm) {
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  float tn = -3.4e38f, tf = 3.4e38f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = __fmul_rn(__fsub_rn(lo[k], o[k]), inv[k]);
    const float q = __fmul_rn(__fsub_rn(hi[k], o[k]), inv[k]);
    if (kNan) {
      tn = nan_max(tn, nan_min(p, q));
      tf = nan_min(tf, nan_max(p, q));
    } else {
      tn = fmaxf(tn, fminf(p, q));
      tf = fminf(tf, fmaxf(p, q));
    }
  }
  bool hit = tf >= (kNan ? nan_max(tn, 0.0f) : fmaxf(tn, 0.0f));
  if (kRanged) hit = hit && tn < tm;
  return hit;
}

// The slab test of a thread's rays against every staged box, 32 boxes a
// word: first, second (-1: none) and count per ray.
template <bool kNan, bool kRanged>
__device__ __forceinline__ void sweep_boxes(const float4* __restrict__ box_a,
                                            const float2* __restrict__ box_b, int n_c,
                                            const float (&o)[kRays][3],
                                            const float (&inv)[kRays][3],
                                            const float (&tm)[kRays], int (&first)[kRays],
                                            int (&second)[kRays], int (&count)[kRays]) {
  for (int c0 = 0; c0 < n_c; c0 += 32) {
    const int m_c = min(32, n_c - c0);
    unsigned word[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) word[r] = 0u;
    unsigned bit = 1u;
#pragma unroll 4
    for (int j = 0; j < m_c; ++j, bit <<= 1) {
      const float4 a = box_a[c0 + j];
      const float2 b = box_b[c0 + j];
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        word[r] |= slab_hit<kNan, kRanged>(a, b, o[r], inv[r], tm[r]) ? bit : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const unsigned w = word[r];
      const int low = __ffs(w) - 1;               // the word's first hit, -1: none
      const int next = __ffs(w & (w - 1u)) - 1;   // its second
      // a new first takes the word's first hit and leaves its second to
      // `second`; an earlier first leaves the word's first hit to it
      const int cand = first[r] < 0 ? (next >= 0 ? c0 + next : -1) : (low >= 0 ? c0 + low : -1);
      second[r] = second[r] < 0 ? cand : second[r];
      first[r] = first[r] < 0 && low >= 0 ? c0 + low : first[r];
      count[r] += __popc(w);
    }
  }
}

// range: every lane's range is tmax_all, or tmax[i] where tmax is given.
// Block b takes rays [b * kChunk, (b + 1) * kChunk), its thread t the rays
// b * kChunk + r * KEY_THREADS + t for r < KEY_RAYS.
template <bool kRanged>
__global__ void __launch_bounds__(kThreads)
signature_key_kernel(const float* __restrict__ boxes, int n_c, const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d, const float* __restrict__ tmax,
                     float tmax_all, const unsigned char* __restrict__ active, int n, int band,
                     int miss_extra, int* __restrict__ key) {
  __shared__ float4 box_a[kMaxBoxes];  // lo.xyz, hi.x
  __shared__ float2 box_b[kMaxBoxes];  // hi.yz
  int finite = 1;
  for (int c = threadIdx.x; c < n_c; c += kThreads) {
    const float* b = boxes + 6 * c;
    const float v[6] = {b[0], b[1], b[2], b[3], b[4], b[5]};
    box_a[c] = make_float4(v[0], v[1], v[2], v[3]);
    box_b[c] = make_float2(v[4], v[5]);
#pragma unroll
    for (int k = 0; k < 6; ++k) finite &= isfinite(v[k]) ? 1 : 0;
  }
  const bool boxes_finite = __syncthreads_and(finite) != 0;

  const int base = blockIdx.x * kChunk + threadIdx.x;
  float o[kRays][3], inv[kRays][3], tm[kRays];
  bool lanes_finite = true;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = base + r * kThreads;
    const bool in = i < n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[r][k] = in ? ray_o[3 * (size_t)i + k] : 0.0f;
      const float d = in ? ray_d[3 * (size_t)i + k] : 1.0f;
      inv[r][k] = 1.0f / (fabsf(d) > 1e-12f ? d : 1e-12f);
      lanes_finite = lanes_finite && isfinite(o[r][k]) && inv[r][k] != 0.0f;
    }
    tm[r] = kRanged ? (tmax != nullptr && in ? tmax[i] : tmax_all) : 0.0f;
  }
  int first[kRays], second[kRays], count[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) first[r] = second[r] = -1, count[r] = 0;
  // warp-uniform: the finite path only where no product can be NaN
  if (boxes_finite && __all_sync(kFull, lanes_finite))
    sweep_boxes<false, kRanged>(box_a, box_b, n_c, o, inv, tm, first, second, count);
  else
    sweep_boxes<true, kRanged>(box_a, box_b, n_c, o, inv, tm, first, second, count);
  const int none = n_c + 1;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = base + r * kThreads;
    if (i >= n) continue;
    const int f8 = min(first[r] >= 0 ? first[r] : none, 255);
    const int s8 = min(second[r] >= 0 ? second[r] : none, 255);
    const int cnt = min(count[r], 63);
    int k = band ? (cnt << 16) | (f8 << 8) | s8 : (f8 << 14) | (s8 << 6) | cnt;
    if (count[r] == 0) k += miss_extra;
    if (active != nullptr && !active[i]) k += kDeadBit;
    key[i] = k;
  }
}

}  // namespace

extern "C" {

// range_mode: 0 no range, 1 every lane's range is tmax_all, 2 tmax[i]
int signature_key(const float* boxes, int n_c, const float* ray_o, const float* ray_d,
                  const float* tmax, float tmax_all, int range_mode,
                  const unsigned char* active, int n, int band, int miss_extra, int* key,
                  void* stream) {
  if (n_c < 1 || n_c > kMaxBoxes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + kChunk - 1) / kChunk;
    if (range_mode == 0) {
      signature_key_kernel<false><<<blocks, kThreads, 0, s>>>(
          boxes, n_c, ray_o, ray_d, nullptr, 0.0f, active, n, band, miss_extra, key);
    } else {
      signature_key_kernel<true><<<blocks, kThreads, 0, s>>>(
          boxes, n_c, ray_o, ray_d, range_mode == 2 ? tmax : nullptr, tmax_all, active, n,
          band, miss_extra, key);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
