// Dense Möller–Trumbore closest-hit and shadow sweeps for Hopper (sm_90a).
//
// Replaces _brute_kernel (radish_pt_tpu/accel/pallas_kernels.py), reached
// through intersect_brute_pallas and occlusion_brute_pallas: every ray
// against every triangle of tri_packed [T, 9] = (v0, e1, e2), no culling.
//
// Arithmetic: the sign-normalised determinant form of
// accel/traverse.py::_mt_core, operation for operation, with every product
// and sum written as __fmul_rn / __fadd_rn / __fsub_rn.  Those intrinsics
// are never contracted into FMAs, so each operation rounds on its own as
// eager torch rounds it, and the kernel gives the plain version's prim,
// dist and barycentrics bit for bit.  A pair is a hit when
//   det >= 1.1920929e-07, bx >= 0, bx <= det, by >= 0, bx + by <= det
// (inclusive edges) and t = (e2·q) * (1 / det) > 0.  Since det >= eps there,
// the reference's max(det, 1e-30) guard never binds, so the reciprocal (an
// IEEE division) is taken only for pairs that pass the edge tests.
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

namespace {

constexpr int kBlock = 128;   // threads (rays) per block
constexpr int kTile = 256;    // triangles staged per shared-memory tile
constexpr float kDetEps = 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int ray, bool live) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const size_t k = (size_t)ray * 3;
    r.ox = o[k];
    r.oy = o[k + 1];
    r.oz = o[k + 2];
    r.dx = d[k];
    r.dy = d[k + 1];
    r.dz = d[k + 2];
  }
  return r;
}

__device__ __forceinline__ void stage(float* s, const float* __restrict__ tri, int base,
                                      int cnt) {
  for (int i = threadIdx.x; i < cnt * 9; i += blockDim.x) s[i] = tri[(size_t)base * 9 + i];
}

// a*b - c*d, each operation rounded on its own
__device__ __forceinline__ float msub(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// (a0*b0 + a1*b1) + a2*b2, each operation rounded on its own
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// One (ray, triangle) pair.  Returns true on a hit, with t, and the
// unnormalised barycentrics bx, by and 1/det for the caller to scale.
__device__ __forceinline__ bool mt_pair(const float* t9, const Ray& r, float& t, float& bx,
                                        float& by, float& inv_det) {
  const float v0x = t9[0], v0y = t9[1], v0z = t9[2];
  const float e1x = t9[3], e1y = t9[4], e1z = t9[5];
  const float e2x = t9[6], e2y = t9[7], e2z = t9[8];
  const float px = msub(r.dy, e2z, r.dz, e2y);
  const float py = msub(r.dz, e2x, r.dx, e2z);
  const float pz = msub(r.dx, e2y, r.dy, e2x);
  const float det0 = dot3(e1x, e1y, e1z, px, py, pz);
  const float sign = det0 < 0.f ? -1.f : 1.f;
  const float det = fabsf(det0);
  const float sx = __fmul_rn(__fsub_rn(r.ox, v0x), sign);
  const float sy = __fmul_rn(__fsub_rn(r.oy, v0y), sign);
  const float sz = __fmul_rn(__fsub_rn(r.oz, v0z), sign);
  bx = dot3(sx, sy, sz, px, py, pz);
  const float qx = msub(sy, e1z, sz, e1y);
  const float qy = msub(sz, e1x, sx, e1z);
  const float qz = msub(sx, e1y, sy, e1x);
  by = dot3(r.dx, r.dy, r.dz, qx, qy, qz);
  if (!(det >= kDetEps && bx >= 0.f && bx <= det && by >= 0.f && __fadd_rn(bx, by) <= det))
    return false;
  inv_det = __frcp_rn(det);  // det >= eps: max(det, 1e-30) is det
  t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  return t > 0.f;
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
