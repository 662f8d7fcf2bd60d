// Plücker closest-hit and shadow sweeps for Hopper (sm_90a).
//
// Both kernels evaluate the decision planes of plucker_planes.cuh: the
// closest hit keeps the exact minimum t (ties to the lower id), the shadow
// test stops at the first blocking triangle.
//
// Layout: one thread per ray, one 128-thread block per 128-lane row.  The
// row's culling mask (int32 words, bit j of word w = cluster 32w+j) is
// block-uniform, so the block walks its set bits together, stages each
// flagged cluster's coefficients in shared memory in tiles of 128
// triangles, and every thread sweeps the tile against its own ray.
// Without a mask the block sweeps every triangle.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"

namespace {

constexpr int kRow = 128;     // threads per block == lanes per mask row

// One thread's closest-hit sweep of triangles [lo, hi) (block-uniform
// bounds), staged through shared memory tile by tile.
__device__ __forceinline__ void closest_sweep(float* s, const float* __restrict__ coeffs,
                                              int lo, int hi, const float* f,
                                              float& best, int& best_id) {
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();  // the previous tile's reads are done
    stage_tile(s, coeffs, base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const Planes p = planes(s + j * kStride, f);
      if (fminf(p.v, p.tdd) >= 0.f) {
        const float t = __fdiv_rn(p.tdd, p.sd);
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
__device__ __forceinline__ bool occlusion_sweep(float* s, const float* __restrict__ coeffs,
                                                int lo, int hi, const float* f,
                                                float tm, int& occ) {
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    // also orders the previous tile's reads before the restage
    if (__syncthreads_and(occ)) return true;
    stage_tile(s, coeffs, base, cnt);
    __syncthreads();
    if (!occ) {
      for (int j = 0; j < cnt; ++j) {
        const Planes p = planes(s + j * kStride, f);
        const float w = fminf(fminf(p.v, p.tdd), tm * p.sd - p.tdd);
        if (w >= 0.f) {
          occ = 1;
          break;
        }
      }
    }
  }
  return false;
}

// Replaces _plucker_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// closest hit of every primary and extension ray.
// Bound on the card: FMA issue — ~40 f32 operations per (ray, triangle)
// pair against coefficient bytes that the whole block shares.  The design
// keeps a tile's coefficients in shared memory (one global read per block,
// broadcast reads after that), each ray's features and running minimum in
// registers, and visits only the clusters its row flags.
__global__ void __launch_bounds__(kRow)
closest_hit_kernel(const float* __restrict__ coeffs, int num_tris, int sub,
                   const float* __restrict__ feats, int n,
                   const int* __restrict__ mask, int n_words,
                   int* __restrict__ prim_out, float* __restrict__ dist_out) {
  __shared__ float s[kTile * kStride];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[10];
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

// Replaces _plucker_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py),
// the any-hit test of every NEE shadow segment.
// Bound on the card: FMA issue, as the closest hit, minus the division and
// the running minimum.  A thread stops testing once its segment is blocked,
// and the block leaves its cluster walk as soon as every lane of the row is
// blocked (one __syncthreads_and per staged tile).
__global__ void __launch_bounds__(kRow)
occlusion_kernel(const float* __restrict__ coeffs, int num_tris, int sub,
                 const float* __restrict__ feats, int n,
                 const int* __restrict__ mask, int n_words,
                 const float* __restrict__ tm_in, int* __restrict__ occ_out) {
  __shared__ float s[kTile * kStride];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[10];
  load_feats(f, feats, ray, live);
  const float tm = live ? tm_in[ray] : -kFltMax;
  int occ = live ? 0 : 1;  // padding lanes count as done for the row exit
  if (mask == nullptr) {
    occlusion_sweep(s, coeffs, 0, num_tris, f, tm, occ);
  } else {
    const int* row = mask + (size_t)blockIdx.x * n_words;
    bool done = false;
    for (int w = 0; w < n_words && !done; ++w) {
      unsigned bits = (unsigned)row[w];
      while (bits && !done) {
        const int c = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        done = occlusion_sweep(s, coeffs, c * sub,
                               min((c + 1) * sub, num_tris), f, tm, occ);
      }
    }
  }
  if (live) occ_out[ray] = occ;
}

}  // namespace

extern "C" {

int plucker_closest_hit(const float* coeffs, int num_tris, int sub,
                        const float* feats, int n, const int* mask, int n_words,
                        int* prim_out, float* dist_out, void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  closest_hit_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, sub, feats, n, mask, n_words, prim_out, dist_out);
  return (int)cudaGetLastError();
}

int plucker_occlusion(const float* coeffs, int num_tris, int sub,
                      const float* feats, int n, const int* mask, int n_words,
                      const float* tm, int* occ_out, void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  occlusion_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, sub, feats, n, mask, n_words, tm, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
