// Banded Plücker closest-hit and shadow sweeps for Hopper (sm_90a): the
// opt-in band engine.
//
// The planes are those of plucker_planes.cuh, bit-identical to the Plücker
// kernels'.  What differs is the culling: each 128-lane row is cut into g
// bands of 128/g lanes (g a power of two, 1 to 128), the prepass
// (accel/band.py::band_mask_words) flags 64-triangle clusters per band, and
// every lane sweeps exactly the clusters of its own band.  The mask holds
// int32 words [rows * g][n_words]: band b of row r at r * g + b, bit j of
// word w = cluster 32w + j; cluster c is triangles [64c, 64c + 64), so a
// winner's id is 64c + its place in the cluster.
//
// Layout: one thread per ray, one 128-thread block per 128-lane row, and
// each warp on its own: it walks the OR of its lanes' band words (for
// g <= 4 one band covers whole warps, so that is the band's own word; for
// g >= 8 a warp holds g/4 bands), stages each cluster in its own slice of
// shared memory (64 triangles x 19 live coefficients, 5 KB) between
// __syncwarp()s, and a lane sweeps the cluster only if its own band's bit
// is set.  So the visited set per lane is exactly its band's flags, as in
// the plain version, not the warp's superset.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"

namespace {

constexpr int kRow = 128;  // threads per block == lanes per row
constexpr int kWarp = 32;
constexpr int kWarps = kRow / kWarp;
constexpr int kCluster = 64;  // triangles per culling cluster
constexpr unsigned kFull = 0xffffffffu;

// Stage cluster c into this warp's slice of shared memory; returns its
// triangle count.  Warp-uniform: every lane of the warp calls it.
__device__ __forceinline__ int stage_cluster(float* s, const float* __restrict__ coeffs,
                                             int c, int num_tris, int lane) {
  const int base = c * kCluster;
  const int cnt = min(kCluster, num_tris - base);
  __syncwarp();  // the previous cluster's reads are done
  stage_tile(s, coeffs, base, cnt, lane, kWarp);
  __syncwarp();
  return cnt;
}

// Replaces _band_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// closest hit of every primary and extension ray on the band engine.
// Bound on the card: FMA throughput — ~41 f32 operations per (ray, triangle)
// pair over the triangles of the band's flagged clusters.  What the bands
// buy is culling: a lane sweeps its band's clusters, not its row's union
// (the reference measured 97 -> 41 sweeps a row at g = 8 on teapot_hires
// bounce rays).  The price here is redundant staging: each warp stages its
// own copy of a cluster (a quarter of the block-wide staging's reuse), and
// for g >= 8 the lanes of a warp whose band did not flag a cluster idle
// while the others sweep it.
__global__ void __launch_bounds__(kRow)
band_closest_hit_kernel(const float* __restrict__ coeffs, int num_tris,
                        const float* __restrict__ feats, int n,
                        const int* __restrict__ mask, int n_words, int g,
                        int* __restrict__ prim_out, float* __restrict__ dist_out) {
  __shared__ float s[kWarps][kCluster * kStride];
  const int lane = threadIdx.x & (kWarp - 1);
  float* sw = s[threadIdx.x / kWarp];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[10];
  load_feats(f, feats, ray, live);
  const int band = threadIdx.x / (kRow / g);
  const int* words = mask + ((size_t)blockIdx.x * g + band) * n_words;
  float best = kFltMax;
  int best_id = -1;
  for (int w = 0; w < n_words; ++w) {
    const unsigned own = (unsigned)words[w];
    unsigned bits = __reduce_or_sync(kFull, own);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int c = w * 32 + b;
      const int cnt = stage_cluster(sw, coeffs, c, num_tris, lane);
      if (!((own >> b) & 1u)) continue;
      for (int j = 0; j < cnt; ++j) {
        const Planes p = planes(sw + j * kStride, f);
        if (fminf(p.v, p.tdd) >= 0.f) {
          const float t = __fdiv_rn(p.tdd, p.sd);
          if (t < best) {  // ids rise through the walk: ties keep the lower
            best = t;
            best_id = c * kCluster + j;
          }
        }
      }
    }
  }
  if (live) {
    prim_out[ray] = best < kFltMax ? best_id : -1;
    dist_out[ray] = best;
  }
}

// Replaces _band_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// any-hit test of every NEE shadow segment on the band engine.
// Bound on the card: FMA throughput, as the closest hit, minus the division.  A
// lane stops testing once its segment is blocked, and a warp leaves its
// walk once all its lanes are settled (__all_sync before each cluster):
// blocked, padding, or with a negative range, which no triangle can block.
__global__ void __launch_bounds__(kRow)
band_occlusion_kernel(const float* __restrict__ coeffs, int num_tris,
                      const float* __restrict__ feats, int n,
                      const int* __restrict__ mask, int n_words, int g,
                      const float* __restrict__ tm_in, int* __restrict__ occ_out) {
  __shared__ float s[kWarps][kCluster * kStride];
  const int lane = threadIdx.x & (kWarp - 1);
  float* sw = s[threadIdx.x / kWarp];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[10];
  load_feats(f, feats, ray, live);
  const float tm = live ? tm_in[ray] : -1.f;
  const int band = threadIdx.x / (kRow / g);
  const int* words = mask + ((size_t)blockIdx.x * g + band) * n_words;
  int occ = 0;
  bool settled = !(tm >= 0.f);
  bool done = false;
  for (int w = 0; w < n_words && !done; ++w) {
    const unsigned own = (unsigned)words[w];
    unsigned bits = __reduce_or_sync(kFull, own);
    while (bits) {
      done = __all_sync(kFull, settled);
      if (done) break;
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int c = w * 32 + b;
      const int cnt = stage_cluster(sw, coeffs, c, num_tris, lane);
      if (settled || !((own >> b) & 1u)) continue;
      for (int j = 0; j < cnt; ++j) {
        const Planes p = planes(sw + j * kStride, f);
        if (fminf(fminf(p.v, p.tdd), tm * p.sd - p.tdd) >= 0.f) {
          occ = 1;
          settled = true;
          break;
        }
      }
    }
  }
  if (live) occ_out[ray] = occ;
}

}  // namespace

extern "C" {

int band_closest_hit(const float* coeffs, int num_tris, const float* feats, int n,
                     const int* mask, int n_words, int g, int* prim_out, float* dist_out,
                     void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  band_closest_hit_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, feats, n, mask, n_words, g, prim_out, dist_out);
  return (int)cudaGetLastError();
}

int band_occlusion(const float* coeffs, int num_tris, const float* feats, int n,
                   const int* mask, int n_words, int g, const float* tm, int* occ_out,
                   void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  band_occlusion_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, feats, n, mask, n_words, g, tm, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
