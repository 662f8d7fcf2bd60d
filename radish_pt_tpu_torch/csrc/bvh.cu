// MTBVH walks for Hopper (sm_90a): closest hit, any-hit and the traversal
// heatmap, one thread a ray.
//
// Replaces three XLA stages of the JAX package (not Pallas bodies):
// intersect_bvh, occlusion_bvh and intersect_bvh_heatmap
// (radish_pt_tpu/accel/traverse.py:408, :469, :570), which walk a
// wavefront in lockstep, one node a step for every lane, with a deferred
// leaf register and tail compaction to work round XLA's gathers.  This is
// the reference renderer's own per-thread design instead
// (DevScene::intersect / testOcclusion / visualizedIntersect,
// scene.h:262-372): each thread walks its ray's threaded order with no
// stack, node + 1 when it descends into a box, the node's miss link when it
// does not, and stops at node B.
//
// Operands (accel/traverse.py::pack_bvh, accel/bvh.py):
// * nodes f32 [6B, 8]: per direction class and node, bmin.xyz, bmax.xyz,
//   the leaf row (int32 bits, -1 inside) and the miss link (int32 bits),
//   read as two 16-byte loads;
// * leaves f32 [R, L*9]: each leaf's L triangles (v0, e1, e2), zero padded
//   (det 0: never hit), read 9 floats a slot;
// * leaf_map i32 [R*L]: slot -> stored triangle id (closest hit only).
//
// Arithmetic, as the plain walk (accel/traverse.py::_walk) rounds it:
// 1/d is __frcp_rn (IEEE: +-0 -> +-inf; -use_fast_math stays out of the
// build); the slab test is _slab_core, every difference and product
// rounded on its own; the pair test is mt_pair.cuh's.  CUDA's fminf / fmaxf
// drop a NaN where torch.minimum / maximum keep it, so the NaN of 0 * inf
// (an origin on a slab plane, that direction component 0) is written out:
// the axis constrains nothing.  The plain version also clamps infinities
// to +-FLT_MAX; that changes no descent, which compares t_near only with a
// finite range, so the kernel does not.  A lane descends only on
// t_near < its best (or its range) and takes a slot only on t < its best,
// both strict, slots in order: the first minimum in slot order wins, as the
// plain walk's dense leaf test picks it.
//
// Bound on the card: f32 issue.  A node visit is 31 operations (the six
// differences and products, six NaN tests, three minima and maxima, t_near,
// t_far, the verdict's three comparisons) and a leaf 16 x 55; the node
// table and the leaves fit the 50 MB L2 (teapot_hires: 8.1 MB and 12.2 MB,
// built by scene/build.py), so device memory sees little more than the
// rays.  The walk diverges: a warp's lanes reach leaves at
// different steps, and the warp runs as long as its longest walk.  A
// simple kernel that is right comes first; ordering rays so that a warp's
// walks agree, or a warp-wide leaf test, is later work.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_pair.cuh"

#ifndef BVH_BLOCK
#define BVH_BLOCK 128
#endif

namespace {

constexpr int kBlock = BVH_BLOCK;  // threads (rays) per block
using mt::kFltMax;
using mt::Ray;
using mt::load_ray;
using mt::mt_pair;

enum Walk { kClosest = 0, kHeatmap = 1, kAnyHit = 2 };

// get_dir_class(-d): the threaded order the ray walks
__device__ __forceinline__ int dir_class(const Ray& r) {
  const float x = -r.dx, y = -r.dy, z = -r.dz;
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const int xc = x > 0.f ? 0 : 1, yc = y > 0.f ? 2 : 3, zc = z > 0.f ? 4 : 5;
  return ax > ay ? (ax > az ? xc : zc) : (ay > az ? yc : zc);
}

// one axis of _slab_core: (lo, hi), both "unconstrained" on a NaN
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o, float inv,
                                          float& lo, float& hi) {
  const float t1 = __fmul_rn(__fsub_rn(bmin, o), inv);
  const float t2 = __fmul_rn(__fsub_rn(bmax, o), inv);
  const bool nan = t1 != t1 || t2 != t2;  // no fast math: a NaN is unequal to itself
  lo = nan ? -kFltMax : fminf(t1, t2);
  hi = nan ? kFltMax : fmaxf(t1, t2);
}

struct Best {
  float t;
  int slot;
  float bx, by;
};

// The walk of one ray.  kClosest / kHeatmap: the best hit (t, slot, scaled
// barycentrics) and the count of descended nodes; kAnyHit: 1 at the first
// slot hit below ``range``, else 0.
template <int kMode>
__device__ __forceinline__ int walk(const float4* __restrict__ nodes, int size,
                                    const float* __restrict__ leaves, int L, const Ray& r,
                                    float range, Best& best) {
  const float ix = __frcp_rn(r.dx), iy = __frcp_rn(r.dy), iz = __frcp_rn(r.dz);
  const float4* __restrict__ order = nodes + 2 * (size_t)dir_class(r) * size;
  float c = range;  // a box must be entered before c to be descended into
  int node = 0, steps = 0;
  while (node < size) {
    const float4 a = __ldg(order + 2 * node);      // bmin.xyz, bmax.x
    const float4 b = __ldg(order + 2 * node + 1);  // bmax.yz, leaf, miss
    float lx, hx, ly, hy, lz, hz;
    slab_axis(a.x, a.w, r.ox, ix, lx, hx);
    slab_axis(a.y, b.x, r.oy, iy, ly, hy);
    slab_axis(a.z, b.y, r.oz, iz, lz, hz);
    const float t_near = fmaxf(lx, fmaxf(ly, lz));
    const float t_far = fminf(hx, fminf(hy, hz));
    if (!(t_far >= 0.f && t_far >= t_near && t_near < c)) {
      node = __float_as_int(b.w);
      continue;
    }
    ++steps;
    const int leaf = __float_as_int(b.z);
    if (leaf >= 0) {
      const float* t9 = leaves + (size_t)leaf * L * 9;
      for (int j = 0; j < L; ++j, t9 += 9) {
        float t, u, v, inv_det;
        if (!mt_pair(t9, r, t, u, v, inv_det) || !(t < c)) continue;
        if (kMode == kAnyHit) return 1;
        c = t;
        best.t = t;
        best.slot = leaf * L + j;
        if (kMode == kClosest) {
          best.bx = __fmul_rn(u, inv_det);
          best.by = __fmul_rn(v, inv_det);
        }
      }
    }
    ++node;
  }
  return kMode == kAnyHit ? 0 : steps;
}

__global__ void __launch_bounds__(kBlock)
bvh_closest_hit_kernel(const float4* __restrict__ nodes, int size,
                       const float* __restrict__ leaves, int L,
                       const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n,
                       const int* __restrict__ leaf_map, int* __restrict__ prim_out,
                       float* __restrict__ dist_out, float* __restrict__ bary_out) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= n) return;
  const Ray r = load_ray(ray_o, ray_d, ray, true);
  Best best{kFltMax, -1, 0.f, 0.f};
  walk<kClosest>(nodes, size, leaves, L, r, kFltMax, best);
  prim_out[ray] = best.slot >= 0 ? leaf_map[best.slot] : -1;
  dist_out[ray] = best.t;
  bary_out[2 * (size_t)ray] = best.bx;
  bary_out[2 * (size_t)ray + 1] = best.by;
}

__global__ void __launch_bounds__(kBlock)
bvh_occlusion_kernel(const float4* __restrict__ nodes, int size,
                     const float* __restrict__ leaves, int L,
                     const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n,
                     const float* __restrict__ tmax, int* __restrict__ occ_out) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= n) return;
  const Ray r = load_ray(ray_o, ray_d, ray, true);
  Best unused{kFltMax, -1, 0.f, 0.f};
  occ_out[ray] = walk<kAnyHit>(nodes, size, leaves, L, r, tmax[ray], unused);
}

__global__ void __launch_bounds__(kBlock)
bvh_heatmap_kernel(const float4* __restrict__ nodes, int size,
                   const float* __restrict__ leaves, int L,
                   const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n,
                   int* __restrict__ steps_out) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= n) return;
  const Ray r = load_ray(ray_o, ray_d, ray, true);
  Best best{kFltMax, -1, 0.f, 0.f};
  steps_out[ray] = walk<kHeatmap>(nodes, size, leaves, L, r, kFltMax, best);
}

}  // namespace

extern "C" {

int bvh_closest_hit(const float* nodes, int size, const float* leaves, int L,
                    const float* ray_o, const float* ray_d, int n, const int* leaf_map,
                    int* prim_out, float* dist_out, float* bary_out, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  bvh_closest_hit_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, n, leaf_map,
      prim_out, dist_out, bary_out);
  return (int)cudaGetLastError();
}

int bvh_occlusion(const float* nodes, int size, const float* leaves, int L,
                  const float* ray_o, const float* ray_d, int n, const float* tmax,
                  int* occ_out, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  bvh_occlusion_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, n, tmax,
      occ_out);
  return (int)cudaGetLastError();
}

int bvh_heatmap(const float* nodes, int size, const float* leaves, int L,
                const float* ray_o, const float* ray_d, int n, int* steps_out,
                void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  bvh_heatmap_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, n, steps_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
