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
//   a, b = (box - o) * inv               (__fsub_rn, then __fmul_rn),
//   tn = max(-3.4e38, min(a, b)), tf = min(3.4e38, max(a, b)) per axis,
//   hit = tf >= max(tn, 0) [and tn < tmax],
// with min and max that propagate NaN as torch.minimum / torch.maximum do
// (fminf / fmaxf would drop it), so the key equals the plain version's as
// an integer on every lane, NaN rays included.
//
// Key: (first (8 bits) << 14) | (second, absolute id (8 bits) << 6) |
// count clamped to 63; the band engine's count-major form is (count << 16)
// | (first << 8) | second.  A missing first or second is C + 1, clamped to
// 255; with C = 256 that is real cluster 255, so there a ray that reaches
// no box also carries bit 22 (miss_extra) and sorts after every hit.
//
// Layout: one thread a ray, 256-thread blocks; the <= 256 boxes (6 KB) are
// staged once a block in shared memory and read by every thread as a
// broadcast, so device memory sees each ray once and the boxes once a
// block.
//
// Bound on the card: f32 issue — ~26 operations per (ray, box) against
// ~53 bytes per ray, so a slab test of C boxes is operation-bound for C
// above ~2.
//
// Launched on the caller's stream; the C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 256;
constexpr int kDeadBit = 1 << 24;

// min / max that return NaN when either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// range_mode: 0 no range, 1 every lane's range is tmax_all, 2 tmax[i]
__global__ void __launch_bounds__(kThreads)
signature_key_kernel(const float* __restrict__ boxes, int n_c, const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d, const float* __restrict__ tmax,
                     float tmax_all, int range_mode, const unsigned char* __restrict__ active,
                     int n, int band, int miss_extra, int* __restrict__ key) {
  __shared__ float sb[kMaxBoxes * 6];
  for (int j = threadIdx.x; j < n_c * 6; j += kThreads) sb[j] = boxes[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float o[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ray_o[3 * i + k];
    const float d = ray_d[3 * i + k];
    inv[k] = 1.0f / (fabsf(d) > 1e-12f ? d : 1e-12f);
  }
  const float tm = range_mode == 2 ? tmax[i] : tmax_all;
  int first = -1, second = -1, count = 0;
  for (int c = 0; c < n_c; ++c) {
    const float* b = sb + 6 * c;
    float tn = -3.4e38f, tf = 3.4e38f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float lo = __fmul_rn(__fsub_rn(b[k], o[k]), inv[k]);
      const float hi = __fmul_rn(__fsub_rn(b[3 + k], o[k]), inv[k]);
      tn = nan_max(tn, nan_min(lo, hi));
      tf = nan_min(tf, nan_max(lo, hi));
    }
    bool hit = tf >= nan_max(tn, 0.0f);
    if (range_mode != 0) hit = hit && tn < tm;
    if (hit) {
      if (first < 0) {
        first = c;
      } else if (second < 0) {
        second = c;
      }
      ++count;
    }
  }
  const int none = n_c + 1;
  const int f8 = min(first >= 0 ? first : none, 255);
  const int s8 = min(second >= 0 ? second : none, 255);
  const int cnt = min(count, 63);
  int k = band ? (cnt << 16) | (f8 << 8) | s8 : (f8 << 14) | (s8 << 6) | cnt;
  if (count == 0) k += miss_extra;
  if (active != nullptr && !active[i]) k += kDeadBit;
  key[i] = k;
}

}  // namespace

extern "C" {

int signature_key(const float* boxes, int n_c, const float* ray_o, const float* ray_d,
                  const float* tmax, float tmax_all, int range_mode,
                  const unsigned char* active, int n, int band, int miss_extra, int* key,
                  void* stream) {
  if (n_c < 1 || n_c > kMaxBoxes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    signature_key_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        boxes, n_c, ray_o, ray_d, tmax, tmax_all, range_mode, active, n, band, miss_extra,
        key);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
