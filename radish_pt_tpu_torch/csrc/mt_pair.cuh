// Möller–Trumbore for one (ray, triangle) pair, each operation rounded on
// its own: shared by the dense sweeps (dense.cu) and the BVH walks (bvh.cu).
//
// The sign-normalised determinant form of accel/traverse.py::_mt_core,
// operation for operation, with every product and sum written as
// __fmul_rn / __fadd_rn / __fsub_rn.  Those intrinsics are never
// contracted into FMAs, so each operation rounds as eager torch rounds it
// and a kernel gives the plain version's t and barycentrics bit for bit.
// A pair is a hit when
//   det >= 1.1920929e-07, bx >= 0, bx <= det, by >= 0, bx + by <= det
// (inclusive edges) and t = (e2·q) * (1 / det) > 0.  Since det >= eps there,
// the reference's max(det, 1e-30) guard never binds, so the reciprocal (an
// IEEE division) is taken only for pairs that pass the edge tests.
#pragma once

#include <cuda_runtime.h>

namespace mt {

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

// a*b - c*d, each operation rounded on its own
__device__ __forceinline__ float msub(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// (a0*b0 + a1*b1) + a2*b2, each operation rounded on its own
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// One (ray, triangle) pair; t9 = (v0, e1, e2).  Returns true on a hit, with
// t, and the unnormalised barycentrics bx, by and 1/det for the caller to
// scale.
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

}  // namespace mt
