// Plücker decision planes shared by the sweep kernels (plucker.cu,
// compact.cu, band.cu), which read the packed table (stage_packed,
// planes(Packed)).
//
// Möller–Trumbore's four decision quantities are planes bilinear in
// per-ray features f = [d, o x d, o, 1] (o centred on the scene) with
// build-time per-triangle coefficients c[T][4][10]:
//   det = c0·f   bx = c1·f   by = c2·f   tdet = c3·f
// Only 19 of the 40 coefficients can be non-zero (det reads d; bx and by
// read d and o x d; tdet reads o and 1), so a packed triangle is those 19
// floats and one zero, read as five float4 from the packed table [T][20].
// With sd = det², bxd = bx·det, byd = by·det, tdd = tdet·det:
//   closest hit:  min(bxd, byd, sd - bxd - byd, sd - eps², tdd) >= 0,
//                 t = tdd / sd
//   shadow:       min(bxd, byd, sd - bxd - byd, sd - eps², tdd,
//                     tm·sd - tdd) >= 0
// Zero triangles (cluster padding) have det = 0 and never pass.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr float kEps2 = 1.1920929e-07f * 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;

struct Planes {
  float sd, v, tdd;
};

// The decision quantities from the four plane values.
__device__ __forceinline__ Planes decide(float det, float bx, float by, float td) {
  Planes p;
  p.sd = det * det;
  const float bxd = bx * det;
  const float byd = by * det;
  float v = fminf(bxd, byd);
  v = fminf(v, p.sd - bxd - byd);
  p.v = fminf(v, p.sd - kEps2);
  p.tdd = td * det;
  return p;
}

// ---- packed operands: a triangle's 19 live coefficients as five float4
// (accel/plucker.py::pack_live_coeffs: slots 0-2 det, 3-8 bx, 9-14 by,
// 15-18 tdet, 19 zero), 80 bytes, 16-byte aligned ----

constexpr int kPackVec = 5;  // float4 per packed triangle

struct Packed {
  float4 a, b, c, d, e;
};

// One triangle read from shared memory with five 16-byte loads.
__device__ __forceinline__ Packed load_packed(const float4* s) {
  Packed t;
  t.a = s[0];
  t.b = s[1];
  t.c = s[2];
  t.d = s[3];
  t.e = s[4];
  return t;
}

// The decision quantities of a packed triangle for features f: det, bx, by
// and tdet each a product then fused multiply-adds, in slot order.
__device__ __forceinline__ Planes planes(const Packed& t, const float* f) {
  float det = t.a.x * f[0];
  det = fmaf(t.a.y, f[1], det);
  det = fmaf(t.a.z, f[2], det);
  float bx = t.a.w * f[0];
  bx = fmaf(t.b.x, f[1], bx);
  bx = fmaf(t.b.y, f[2], bx);
  bx = fmaf(t.b.z, f[3], bx);
  bx = fmaf(t.b.w, f[4], bx);
  bx = fmaf(t.c.x, f[5], bx);
  float by = t.c.y * f[0];
  by = fmaf(t.c.z, f[1], by);
  by = fmaf(t.c.w, f[2], by);
  by = fmaf(t.d.x, f[3], by);
  by = fmaf(t.d.y, f[4], by);
  by = fmaf(t.d.z, f[5], by);
  float td = t.d.w * f[6];
  td = fmaf(t.e.x, f[7], td);
  td = fmaf(t.e.y, f[8], td);
  td = fmaf(t.e.z, f[9], td);
  return decide(det, bx, by, td);
}

// Start the copy of packed triangles [base, base + n) into s, thread
// ``tid`` of ``threads``; the caller commits and waits.
__device__ __forceinline__ void stage_packed(float4* s, const float4* __restrict__ packed,
                                             int base, int n, int tid, int threads) {
  const float4* src = packed + (size_t)base * kPackVec;
  for (int i = tid; i < n * kPackVec; i += threads) cp_async16(s + i, src + i);
}

__device__ __forceinline__ void load_feats(float* f, const float* __restrict__ feats,
                                           int ray, bool live) {
#pragma unroll
  for (int k = 0; k < 10; ++k) f[k] = live ? feats[(size_t)ray * 10 + k] : 0.f;
}

}  // namespace
