// Quadratic-form closest-hit and shadow sweeps for Hopper (sm_90a): the
// opt-in quad engine.
//
// Each of Möller–Trumbore's decision quantities, multiplied through by det,
// is a linear form in 27 ray monomials f (d⊗d sym, m⊗d, o⊗d, d; o centred
// on the scene, m = o x d) with build-time per-triangle coefficients
// c[T][6][28] (slot 27, the constant monomial, always has coefficient 0):
//   q1 = bx·det, q2 = by·det, q3 = det² - (bx + by)·det,
//   q4 = det² - eps²·|d|², q5 = t·det·det, q6 = det² - t·det·det.
//   closest hit:  min(q1..q5) >= 0, t = q5 / (q4 + eps²)
//   shadow:       min(q1..q6) >= 0 over segments with t in [0, 1]
// Every form is summed over the 27 monomials in order, one fmaf per term
// from 0, as accel/quad.py::forms sums it: kernel and plain version agree
// to the ulp (the same winners on every lane at 800x800).
//
// Layout: one thread per ray, one 128-thread block per 128-lane mask row.
// The row's cluster mask (int32 words, bit j of word w = cluster 32w+j) is
// block-uniform, so the block walks its set bits together, stages each
// flagged cluster's forms in shared memory 64 triangles at a time (5 x 28
// floats a triangle for the closest hit, 35,840 bytes a tile; 6 x 28 for
// the shadow test, 43,008 bytes), and every thread evaluates the tile
// against its own ray's 27 features, held in registers.  Without a mask
// the block sweeps every triangle.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;       // threads per block == lanes per mask row
constexpr int kTile = 64;       // triangles staged per shared-memory tile
constexpr int kFeats = 28;      // floats per feature / form row (27 live)
constexpr int kVec = kFeats / 4;  // float4 per row
constexpr int kStored = 6;      // forms stored per triangle
constexpr float kEps2 = 1.1920929e-07f * 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;

// Stage triangles [base, base + n) as their first P forms.
template <int P>
__device__ __forceinline__ void stage(float4* s, const float4* __restrict__ coeffs,
                                      int base, int n) {
  constexpr int per = P * kVec;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int j = i / per;
    s[i] = coeffs[(size_t)(base + j) * (kStored * kVec) + (i - j * per)];
  }
}

// The P forms of staged triangle s for features f.
template <int P>
__device__ __forceinline__ void forms(const float4* s, const float* f, float* q) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float4 c = s[p * kVec + k];
      acc = fmaf(c.x, f[4 * k], acc);
      acc = fmaf(c.y, f[4 * k + 1], acc);
      acc = fmaf(c.z, f[4 * k + 2], acc);
      if (k + 1 < kVec) acc = fmaf(c.w, f[4 * k + 3], acc);  // not slot 27
    }
    q[p] = acc;
  }
}

__device__ __forceinline__ void load_feats(float* f, const float4* __restrict__ feats,
                                           int ray, bool live) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float4 v = live ? feats[(size_t)ray * kVec + k] : make_float4(0.f, 0.f, 0.f, 0.f);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// One thread's closest-hit sweep of triangles [lo, hi) (block-uniform
// bounds), staged through shared memory tile by tile.
__device__ __forceinline__ void closest_sweep(float4* s, const float4* __restrict__ coeffs,
                                              int lo, int hi, const float* f,
                                              float& best, int& best_id) {
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();  // the previous tile's reads are done
    stage<5>(s, coeffs, base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      float q[5];
      forms<5>(s + j * 5 * kVec, f, q);
      const float m = fminf(fminf(fminf(q[0], q[1]), fminf(q[2], q[3])), q[4]);
      if (m >= 0.f) {
        const float t = __fdiv_rn(q[4], __fadd_rn(q[3], kEps2));
        if (t < best) {  // ids rise through the sweep: ties keep the lower
          best = t;
          best_id = base + j;
        }
      }
    }
  }
}

// One thread's shadow sweep of triangles [lo, hi); returns true once every
// lane of the block is blocked (the row is done).
__device__ __forceinline__ bool occlusion_sweep(float4* s, const float4* __restrict__ coeffs,
                                                int lo, int hi, const float* f, int& occ) {
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    // also orders the previous tile's reads before the restage
    if (__syncthreads_and(occ)) return true;
    stage<kStored>(s, coeffs, base, cnt);
    __syncthreads();
    if (!occ) {
      for (int j = 0; j < cnt; ++j) {
        float q[kStored];
        forms<kStored>(s + j * kStored * kVec, f, q);
        const float m = fminf(fminf(fminf(q[0], q[1]), fminf(q[2], q[3])),
                              fminf(q[4], q[5]));
        if (m >= 0.f) {
          occ = 1;
          break;
        }
      }
    }
  }
  return false;
}

// Replaces _quad_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// closest hit of every primary and extension ray on the quad engine.
// Bound on the card: f32 FMA throughput — 5 forms x 27 terms = 135 fused
// multiply-adds per (ray, triangle) pair (265 flops), seven times the
// Plücker sweep's 19 products, against coefficient bytes the whole block
// shares.  The design keeps a tile's forms in shared memory (one global
// read per block, broadcast float4 reads after that, one per four FMAs),
// each ray's features and running minimum in registers, and visits only
// the clusters its row flags.
__global__ void __launch_bounds__(kRow)
quad_closest_hit_kernel(const float4* __restrict__ coeffs, int num_tris, int sub,
                        const float4* __restrict__ feats, int n,
                        const int* __restrict__ mask, int n_words,
                        int* __restrict__ prim_out, float* __restrict__ dist_out) {
  __shared__ float4 s[kTile * 5 * kVec];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[kFeats];
  load_feats(f, feats, ray, live);
  float best = kFltMax;
  int best_id = -1;
  if (mask == nullptr) {
    closest_sweep(s, coeffs, 0, num_tris, f, best, best_id);
  } else {
    const int* row = mask + (size_t)blockIdx.x * n_words;
    for (int w = 0; w < n_words; ++w) {
      unsigned bits = (unsigned)row[w];
      while (bits) {
        const int c = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        closest_sweep(s, coeffs, c * sub, min((c + 1) * sub, num_tris), f,
                      best, best_id);
      }
    }
  }
  if (live) {
    prim_out[ray] = best < kFltMax ? best_id : -1;
    dist_out[ray] = best;
  }
}

// Replaces _quad_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// any-hit test of every NEE shadow segment on the quad engine.
// Bound on the card: f32 FMA throughput, 6 forms x 27 terms = 162 fused
// multiply-adds per pair (318 flops).  A thread stops testing once its
// segment is blocked, and the block leaves its cluster walk as soon as
// every lane of the row is blocked (one __syncthreads_and per staged
// tile).  A zero-length segment has all-zero features: every form is 0,
// so the first triangle swept blocks it, as in the reference.
__global__ void __launch_bounds__(kRow)
quad_occlusion_kernel(const float4* __restrict__ coeffs, int num_tris, int sub,
                      const float4* __restrict__ feats, int n,
                      const int* __restrict__ mask, int n_words, int* __restrict__ occ_out) {
  __shared__ float4 s[kTile * kStored * kVec];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[kFeats];
  load_feats(f, feats, ray, live);
  int occ = live ? 0 : 1;  // padding lanes count as done for the row exit
  if (mask == nullptr) {
    occlusion_sweep(s, coeffs, 0, num_tris, f, occ);
  } else {
    const int* row = mask + (size_t)blockIdx.x * n_words;
    bool done = false;
    for (int w = 0; w < n_words && !done; ++w) {
      unsigned bits = (unsigned)row[w];
      while (bits && !done) {
        const int c = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        done = occlusion_sweep(s, coeffs, c * sub, min((c + 1) * sub, num_tris), f, occ);
      }
    }
  }
  if (live) occ_out[ray] = occ;
}

}  // namespace

extern "C" {

int quad_closest_hit(const float* coeffs, int num_tris, int sub, const float* feats, int n,
                     const int* mask, int n_words, int* prim_out, float* dist_out,
                     void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  quad_closest_hit_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(coeffs), num_tris, sub,
      reinterpret_cast<const float4*>(feats), n, mask, n_words, prim_out, dist_out);
  return (int)cudaGetLastError();
}

int quad_occlusion(const float* coeffs, int num_tris, int sub, const float* feats, int n,
                   const int* mask, int n_words, int* occ_out, void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  quad_occlusion_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(coeffs), num_tris, sub,
      reinterpret_cast<const float4*>(feats), n, mask, n_words, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
