// Compact work-list engine for Hopper (sm_90a): the sphere prepass and the
// compact closest-hit and shadow sweeps.
//
// A row group is 256 consecutive lanes (two 8x16 pixel tiles); a unit is
// g consecutive 64-triangle culling clusters (g = 1 up to 4,096 clusters).
//
// 1. sphere_flags_kernel: per (row group, unit), whether some lane's ray
//    passes the unit's bounding sphere inside its range, and the entry
//    distance tn (min over the flagging lanes of the sphere window start).
// 2. The work list (plain torch, accel/compact.py::work_list): the flagged
//    (row group, unit) pairs, row-major, each row's units near to far, with
//    offsets[row]..offsets[row+1] the row group's slice.
// 3. compact_closest_hit_kernel / compact_occlusion_kernel: one block per
//    row group walks its slice; each unit's triangles are staged in shared
//    memory and every thread sweeps them against its own ray with the
//    decision planes of plucker_planes.cuh.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"

namespace {

constexpr int kGroup = 256;   // lanes per row group == threads per block
constexpr int kSphereK = 16;  // sphere-test features per ray
// A unit is skipped once every lane's best t, widened by this margin, is
// below its entry distance (the reference's test, pallas_kernels.py:1389).
constexpr float kSkipMargin = 1.f + 1e-4f;

__device__ __forceinline__ float term(float acc, float f, float c) {
  // unfused: the plain version adds the same products in the same order
  return __fadd_rn(acc, __fmul_rn(f, c));
}

// coefficient k of plane p (0: A, 1: C, 2: E) for unit u
__device__ __forceinline__ float coef(const float* __restrict__ planes, int n_units,
                                      int p, int k, int u) {
  return planes[((size_t)p * kSphereK + k) * n_units + u];
}

// Replaces _sphere_flag_kernel (radish_pt_tpu/accel/pallas_kernels.py).
// Features f[16] = [dd6, (m x d)3, |m|², d.o, d3, tm, 1] per ray (m = o x d,
// o relative to the scene centre); planes [3][16][units] give per unit
//   A = r² - dist²(ray, centre) >= 0, C = t* + r >= 0, E = tm - t* + r >= 0
// and a lane flags the unit when min(A, C, E) >= 0.  Only the terms that
// accel/compact.py::_sphere_plane_coeffs can make non-zero are read:
// A: f0..f9, f15; C: f10..f13, f15; E: f10..f15.  Each plane is summed in
// term order with unfused f32 multiplies and adds, as the plain version
// sums it, so the two agree bit for bit (the TPU kernel instead splits
// both operands into bf16 parts and leans on the planes' slack terms).
// Bound on the card: f32 issue, ~50 operations per (lane, unit) pair.  One
// block per row group stages its 256 lanes' features in shared memory (16
// KB, read as broadcasts); each thread owns one unit, keeps its 21 plane
// coefficients in registers and loops over the lanes, so the flags and tn
// are written once, coalesced.
__global__ void __launch_bounds__(kGroup)
sphere_flags_kernel(const float* __restrict__ feats, const float* __restrict__ planes,
                    int n_units, unsigned char* __restrict__ flags_out,
                    float* __restrict__ tn_out) {
  __shared__ float sf[kGroup * kSphereK];
  const size_t row = blockIdx.x;
  const float* src = feats + row * kGroup * kSphereK;
  for (int i = threadIdx.x; i < kGroup * kSphereK; i += kGroup) sf[i] = src[i];
  __syncthreads();
  const int u = blockIdx.y * kGroup + threadIdx.x;
  if (u >= n_units) return;
  float ca[11], cc[5], ce[6];
#pragma unroll
  for (int k = 0; k < 10; ++k) ca[k] = coef(planes, n_units, 0, k, u);
  ca[10] = coef(planes, n_units, 0, 15, u);
#pragma unroll
  for (int k = 0; k < 4; ++k) cc[k] = coef(planes, n_units, 1, 10 + k, u);
  cc[4] = coef(planes, n_units, 1, 15, u);
#pragma unroll
  for (int k = 0; k < 6; ++k) ce[k] = coef(planes, n_units, 2, 10 + k, u);
  // C's constant is r + slack for a real unit (-1e37 for a padding one):
  // t* - r = C - 2r bounds every hit inside the sphere from below
  const float rl2 = 2.f * fmaxf(cc[4], 0.f);
  bool flag = false;
  float tn = kFltMax;
  for (int l = 0; l < kGroup; ++l) {
    const float* f = sf + l * kSphereK;
    float a = __fmul_rn(f[0], ca[0]);
#pragma unroll
    for (int k = 1; k < 10; ++k) a = term(a, f[k], ca[k]);
    a = term(a, f[15], ca[10]);
    float c = __fmul_rn(f[10], cc[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) c = term(c, f[10 + k], cc[k]);
    c = term(c, f[15], cc[4]);
    float e = __fmul_rn(f[10], ce[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) e = term(e, f[10 + k], ce[k]);
    if (fminf(fminf(a, c), e) >= 0.f) {
      flag = true;
      tn = fminf(tn, fmaxf(__fsub_rn(c, rl2), 0.f));
    }
  }
  flags_out[row * n_units + u] = flag;
  tn_out[row * n_units + u] = tn;
}

// Replaces _plucker_compact_kernel (radish_pt_tpu/accel/pallas_kernels.py),
// the closest hit of every primary and extension ray above 131,072
// triangles.
// Bound on the card: FMA issue, ~40 f32 operations per (ray, triangle)
// pair, as the Plücker sweep.  What the list adds is culling: a block
// sweeps only the units its row group flagged, near to far, and before
// each unit the block votes (__syncthreads_or) whether any live lane's
// best t could still reach the unit's entry tn; once none can, no later
// unit can either (tn rises along the slice) and the block stops.  The
// walk is not in id order, so a tie keeps the lower id explicitly.
// A lane with negative tmax is dead: it neither sweeps nor votes, and
// returns a miss.
__global__ void __launch_bounds__(kGroup)
compact_closest_hit_kernel(const float* __restrict__ coeffs, int num_tris, int unit_tris,
                           const float* __restrict__ feats, const float* __restrict__ tmax,
                           int n, const int* __restrict__ items,
                           const float* __restrict__ item_tn,
                           const int* __restrict__ offsets, int* __restrict__ prim_out,
                           float* __restrict__ dist_out) {
  __shared__ float s[kTile * kStride];
  const int ray = blockIdx.x * kGroup + threadIdx.x;
  const bool live = ray < n && tmax[ray] >= 0.f;
  float f[10];
  load_feats(f, feats, ray, live);
  float best = kFltMax;
  int best_id = -1;
  const int end = offsets[blockIdx.x + 1];
  for (int w = offsets[blockIdx.x]; w < end; ++w) {
    // also orders the previous unit's shared-memory reads before restaging
    if (!__syncthreads_or(live && best * kSkipMargin >= item_tn[w])) break;
    const int lo = items[w] * unit_tris;
    const int hi = min(lo + unit_tris, num_tris);
    for (int base = lo; base < hi; base += kTile) {
      const int cnt = min(kTile, hi - base);
      if (base != lo) __syncthreads();
      stage_tile(s, coeffs, base, cnt);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < cnt; ++j) {
        const Planes p = planes(s + j * kStride, f);
        if (fminf(p.v, p.tdd) >= 0.f) {
          const float t = __fdiv_rn(p.tdd, p.sd);
          const int id = base + j;
          if (t < best || (t == best && id < best_id)) {
            best = t;
            best_id = id;
          }
        }
      }
    }
  }
  if (ray < n) {
    prim_out[ray] = best < kFltMax ? best_id : -1;
    dist_out[ray] = best;
  }
}

// Replaces _plucker_compact_occl_kernel (radish_pt_tpu/accel/
// pallas_kernels.py), the any-hit test of every NEE shadow segment above
// 131,072 triangles.
// Bound on the card: FMA issue, as the closest hit, minus the division.  A
// thread stops testing once its segment is blocked; the block leaves its
// slice (one __syncthreads_and per staged tile) once every lane is settled:
// blocked, or with a negative range, which no triangle can block.
__global__ void __launch_bounds__(kGroup)
compact_occlusion_kernel(const float* __restrict__ coeffs, int num_tris, int unit_tris,
                         const float* __restrict__ feats, const float* __restrict__ tm_in,
                         int n, const int* __restrict__ items,
                         const int* __restrict__ offsets, int* __restrict__ occ_out) {
  __shared__ float s[kTile * kStride];
  const int ray = blockIdx.x * kGroup + threadIdx.x;
  const bool live = ray < n;
  float f[10];
  load_feats(f, feats, ray, live);
  const float tm = live ? tm_in[ray] : -1.f;
  int occ = 0;
  bool settled = !(tm >= 0.f);
  bool done = false;
  const int end = offsets[blockIdx.x + 1];
  for (int w = offsets[blockIdx.x]; w < end && !done; ++w) {
    const int lo = items[w] * unit_tris;
    const int hi = min(lo + unit_tris, num_tris);
    for (int base = lo; base < hi; base += kTile) {
      // also orders the previous tile's reads before the restage
      done = __syncthreads_and(settled);
      if (done) break;
      const int cnt = min(kTile, hi - base);
      stage_tile(s, coeffs, base, cnt);
      __syncthreads();
      if (settled) continue;
      for (int j = 0; j < cnt; ++j) {
        const Planes p = planes(s + j * kStride, f);
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

int compact_sphere_flags(const float* feats, const float* planes, int rows, int n_units,
                         unsigned char* flags_out, float* tn_out, void* stream) {
  const dim3 grid(rows, (n_units + kGroup - 1) / kGroup);
  sphere_flags_kernel<<<grid, kGroup, 0, (cudaStream_t)stream>>>(
      feats, planes, n_units, flags_out, tn_out);
  return (int)cudaGetLastError();
}

int compact_closest_hit(const float* coeffs, int num_tris, int unit_tris,
                        const float* feats, const float* tmax, int n, const int* items,
                        const float* item_tn, const int* offsets, int rows,
                        int* prim_out, float* dist_out, void* stream) {
  compact_closest_hit_kernel<<<rows, kGroup, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, unit_tris, feats, tmax, n, items, item_tn, offsets, prim_out,
      dist_out);
  return (int)cudaGetLastError();
}

int compact_occlusion(const float* coeffs, int num_tris, int unit_tris,
                      const float* feats, const float* tm, int n, const int* items,
                      const int* offsets, int rows, int* occ_out, void* stream) {
  compact_occlusion_kernel<<<rows, kGroup, 0, (cudaStream_t)stream>>>(
      coeffs, num_tris, unit_tris, feats, tm, n, items, offsets, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
