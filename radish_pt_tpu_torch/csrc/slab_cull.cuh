// Per-lane slab test of a ray against culling-cluster boxes, and a warp's
// vote over it: the culling the sweep kernels run themselves (plucker.cu).
//
// slab_hit is accel/plucker.py::lane_cluster_flags_plain operation for
// operation, each rounded on its own (nvcc would otherwise contract the
// subtraction and the product), so a lane's flag is the same bit on the
// card and in the plain version: the flag decides which triangles a lane
// may hit, so it is part of the result.  fmaxf / fminf drop a NaN where
// torch.maximum / torch.minimum keep it: rays and boxes are finite here.
//
// slab_reach is the test a single ray uses to pass over a cluster its warp
// flags: the box grown by a slack on every side, and the entry distance
// held against what the ray can still use.  It decides no result (a ray
// skips only where no triangle can pass its f32 planes; the slack is shown
// conservative by accel/plucker.py::lane_skip_flags_plain and its tests),
// so it is free to fuse.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kSlabFltMax = 3.402823466e38f;
constexpr unsigned kFullWarp = 0xffffffffu;

// What the slab test reads of one ray: origin, 1 / direction, range.
struct SlabRay {
  float ox, oy, oz, ix, iy, iz, tm;
};

// 1 / d with |d| <= 1e-12 clamped to +1e-12 (the sign is lost, as in the
// reference prepass).
__device__ __forceinline__ float slab_inv(float d) {
  return __frcp_rn(fabsf(d) > 1e-12f ? d : 1e-12f);
}

// Lane ``ray`` of ``n``: its origin, direction and range (``tmax`` null:
// FLT_MAX).  A lane past the end is padded as the reference pads a ragged
// last group: o = 0, d = 1, range 0 (FLT_MAX without tmax).
__device__ __forceinline__ SlabRay slab_ray(const float* __restrict__ ray_o,
                                            const float* __restrict__ ray_d,
                                            const float* __restrict__ tmax, int ray, int n) {
  SlabRay r;
  if (ray < n) {
    r.ox = ray_o[(size_t)ray * 3 + 0];
    r.oy = ray_o[(size_t)ray * 3 + 1];
    r.oz = ray_o[(size_t)ray * 3 + 2];
    r.ix = slab_inv(ray_d[(size_t)ray * 3 + 0]);
    r.iy = slab_inv(ray_d[(size_t)ray * 3 + 1]);
    r.iz = slab_inv(ray_d[(size_t)ray * 3 + 2]);
    r.tm = tmax ? tmax[ray] : kSlabFltMax;
  } else {
    r.ox = r.oy = r.oz = 0.f;
    r.ix = r.iy = r.iz = slab_inv(1.f);
    r.tm = tmax ? 0.f : kSlabFltMax;
  }
  return r;
}

// Whether the ray may hit box b = (lo.xyz, hi.xyz) inside its range: the
// near plane tn = max over axes of min(a, b), the far plane tf = min of
// max(a, b), flagged when tf >= max(tn, 0) and tn < tm.
__device__ __forceinline__ bool slab_hit(const SlabRay& r, const float* __restrict__ b) {
  float tn = -kSlabFltMax;
  float tf = kSlabFltMax;
  float lo = __fmul_rn(__fsub_rn(b[0], r.ox), r.ix);
  float hi = __fmul_rn(__fsub_rn(b[3], r.ox), r.ix);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, fmaxf(lo, hi));
  lo = __fmul_rn(__fsub_rn(b[1], r.oy), r.iy);
  hi = __fmul_rn(__fsub_rn(b[4], r.oy), r.iy);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, fmaxf(lo, hi));
  lo = __fmul_rn(__fsub_rn(b[2], r.oz), r.iz);
  hi = __fmul_rn(__fsub_rn(b[5], r.oz), r.iz);
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, fmaxf(lo, hi));
  return tf >= fmaxf(tn, 0.f) && tn < r.tm;
}

// Whether the ray can meet box b grown by ``slack`` on every side before
// ``reach`` (accel/plucker.py::lane_skip_flags_plain).
__device__ __forceinline__ bool slab_reach(const SlabRay& r, const float* __restrict__ b,
                                           float slack, float reach) {
  float lo = (b[0] - slack - r.ox) * r.ix;
  float hi = (b[3] + slack - r.ox) * r.ix;
  float tn = fminf(lo, hi);
  float tf = fmaxf(lo, hi);
  lo = (b[1] - slack - r.oy) * r.iy;
  hi = (b[4] + slack - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, fmaxf(lo, hi));
  lo = (b[2] - slack - r.oz) * r.iz;
  hi = (b[5] + slack - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(lo, hi));
  tf = fminf(tf, fmaxf(lo, hi));
  return tf >= fmaxf(tn, 0.f) && tn <= reach;
}

// The calling warp's cluster words: bit j of words[w] is set when some
// lane's ray may hit box 32·w + j of ``bounds`` [n_clusters][6].  Every
// lane of the warp calls it with its own ray; lane 0 writes the words
// (``words`` is the warp's own, ceil(n_clusters / 32) long), or with
// ``kOr`` ORs them into ``words`` shared by the block's warps and zeroed
// before.  The boxes are read at one address by the whole warp: one
// broadcast load each.  Returns the largest extent of the boxes' union
// along an axis (the scene's scale, the same in every lane).
template <bool kOr = false>
__device__ __forceinline__ float warp_cluster_words(unsigned* words,
                                                    const float* __restrict__ bounds,
                                                    int n_clusters, const SlabRay& r) {
  const int lane = threadIdx.x & 31;
  float lo[3] = {kSlabFltMax, kSlabFltMax, kSlabFltMax};
  float hi[3] = {-kSlabFltMax, -kSlabFltMax, -kSlabFltMax};
  for (int c0 = 0; c0 < n_clusters; c0 += 32) {
    unsigned mine = 0;  // this lane's own flags of the 32 boxes
    const int cnt = min(32, n_clusters - c0);
    for (int j = 0; j < cnt; ++j) {
      const float* b = bounds + (size_t)(c0 + j) * 6;
      if (slab_hit(r, b)) mine |= 1u << j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], b[k]);
        hi[k] = fmaxf(hi[k], b[3 + k]);
      }
    }
    const unsigned word = __reduce_or_sync(kFullWarp, mine);
    if (lane == 0) {
      if (!kOr) {
        words[c0 >> 5] = word;
      } else if (word) {
        atomicOr(words + (c0 >> 5), word);
      }
    }
  }
  return fmaxf(fmaxf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
}

}  // namespace
