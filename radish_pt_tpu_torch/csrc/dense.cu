// Dense Möller–Trumbore closest-hit and shadow sweeps for Hopper (sm_90a).
//
// Replaces _brute_kernel (radish_pt_tpu/accel/pallas_kernels.py), reached
// through intersect_brute_pallas and occlusion_brute_pallas: every ray
// against every triangle of tri_packed [T, 9] = (v0, e1, e2), no culling.
//
// Arithmetic: mt_pair.cuh's Möller–Trumbore, every operation rounded on
// its own as the plain version rounds it, so the kernel gives its prim,
// dist and barycentrics bit for bit.
//
// Layout: one thread per ray, 128-thread blocks.  The block stages the
// triangles through shared memory kTile at a time (9 floats each, one
// global read per block, broadcast reads after that); each thread keeps
// its running best (t, id, bx, by) in registers.  Triangles go by in
// increasing id and a hit replaces the best only when strictly nearer, so
// ties keep the lower id.
//
// Bound on the card: f32 issue — ~55 operations per (ray, triangle) pair
// against 36 bytes per triangle that the whole block shares; the design
// keeps those bytes in shared memory and the ray in registers, so device
// memory sees each ray once and each triangle once per block.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_pair.cuh"

namespace {

constexpr int kBlock = 128;   // threads (rays) per block
constexpr int kTile = 256;    // triangles staged per shared-memory tile
using mt::kFltMax;
using mt::Ray;
using mt::load_ray;
using mt::mt_pair;

__device__ __forceinline__ void stage(float* s, const float* __restrict__ tri, int base,
                                      int cnt) {
  for (int i = threadIdx.x; i < cnt * 9; i += blockDim.x) s[i] = tri[(size_t)base * 9 + i];
}

__global__ void __launch_bounds__(kBlock)
dense_closest_hit_kernel(const float* __restrict__ tri, int num_tris,
                         const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                         int n, int* __restrict__ prim_out, float* __restrict__ dist_out,
                         float* __restrict__ bary_out) {
  __shared__ float s[kTile * 9];
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float best = kFltMax, best_bx = 0.f, best_by = 0.f;
  int best_id = -1;
  for (int base = 0; base < num_tris; base += kTile) {
    const int cnt = min(kTile, num_tris - base);
    __syncthreads();  // the previous tile's reads are done
    stage(s, tri, base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      float t, bx, by, inv_det;
      if (mt_pair(s + j * 9, r, t, bx, by, inv_det) && t < best) {
        best = t;
        best_id = base + j;
        best_bx = __fmul_rn(bx, inv_det);
        best_by = __fmul_rn(by, inv_det);
      }
    }
  }
  if (live) {
    prim_out[ray] = best_id;
    dist_out[ray] = best;
    bary_out[2 * (size_t)ray] = best_bx;
    bary_out[2 * (size_t)ray + 1] = best_by;
  }
}

// Any-hit: a segment is blocked when some triangle gives a hit with
// t < tmax.  That is the reference's closest-hit-then-compare, since the
// nearest hit is below tmax exactly when some hit is.  A thread stops
// testing at its first such hit, and the block leaves the tile loop once
// every lane has (one __syncthreads_and per staged tile).
__global__ void __launch_bounds__(kBlock)
dense_occlusion_kernel(const float* __restrict__ tri, int num_tris,
                       const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                       const float* __restrict__ tmax_in, int n, int* __restrict__ occ_out) {
  __shared__ float s[kTile * 9];
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  const float tmax = live ? tmax_in[ray] : -kFltMax;
  int occ = live ? 0 : 1;  // padding lanes count as done for the block exit
  for (int base = 0; base < num_tris; base += kTile) {
    const int cnt = min(kTile, num_tris - base);
    // also orders the previous tile's reads before the restage
    if (__syncthreads_and(occ)) break;
    stage(s, tri, base, cnt);
    __syncthreads();
    if (!occ) {
      for (int j = 0; j < cnt; ++j) {
        float t, bx, by, inv_det;
        if (mt_pair(s + j * 9, r, t, bx, by, inv_det) && t < tmax) {
          occ = 1;
          break;
        }
      }
    }
  }
  if (live) occ_out[ray] = occ;
}

}  // namespace

extern "C" {

int dense_closest_hit(const float* tri, int num_tris, const float* ray_o, const float* ray_d,
                      int n, int* prim_out, float* dist_out, float* bary_out, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  dense_closest_hit_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      tri, num_tris, ray_o, ray_d, n, prim_out, dist_out, bary_out);
  return (int)cudaGetLastError();
}

int dense_occlusion(const float* tri, int num_tris, const float* ray_o, const float* ray_d,
                    const float* tmax, int n, int* occ_out, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  dense_occlusion_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      tri, num_tris, ray_o, ray_d, tmax, n, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
