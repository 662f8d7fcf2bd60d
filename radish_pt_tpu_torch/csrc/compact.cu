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
// 3. compact_closest_hit_kernel / compact_occlusion_kernel: one walk
//    (compact_sweep) for both: a block walks its row group's slice for 64
//    of its lanes, culling again per lane against each unit's bounding
//    sphere; each wanted unit's triangles are staged from the packed table
//    in shared memory and swept against the rays that want them with the
//    decision planes of plucker_planes.cuh.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"

namespace {

constexpr int kGroup = 256;   // lanes per row group
constexpr int kSphereK = 16;  // sphere-test features per ray
constexpr int kCluster = 64;  // triangles per culling cluster == per staged tile
// Each sweep kernel's shape: the lanes of the row group one block walks
// (32, 64, 128 or 256: the group's slice is walked by 256 / lanes blocks,
// each for its own lanes), and from how many wanting lanes on a warp
// sweeps a unit with every lane against its own ray instead of one wanting
// ray at a time (1: always; 33: never).  -DCOMPACT_BLOCK_LANES /
// -DCOMPACT_LOCKSTEP (closest hit) and -DCOMPACT_OCCL_BLOCK_LANES /
// -DCOMPACT_OCCL_LOCKSTEP (shadow) build another shape for a measurement
// (radish_pt_tpu_torch/tune.py).
#ifndef COMPACT_BLOCK_LANES
#define COMPACT_BLOCK_LANES 64
#endif
#ifndef COMPACT_LOCKSTEP
#define COMPACT_LOCKSTEP 12
#endif
#ifndef COMPACT_OCCL_BLOCK_LANES
#define COMPACT_OCCL_BLOCK_LANES 64
#endif
#ifndef COMPACT_OCCL_LOCKSTEP
#define COMPACT_OCCL_LOCKSTEP 12
#endif
constexpr int kBlockLanes = COMPACT_BLOCK_LANES;
constexpr int kLockstep = COMPACT_LOCKSTEP;
constexpr int kOcclLanes = COMPACT_OCCL_BLOCK_LANES;
constexpr int kOcclLockstep = COMPACT_OCCL_LOCKSTEP;
// A unit is skipped once a lane's best t, widened by this margin, is below
// its entry distance (the reference's test, pallas_kernels.py:1389).
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

// One lane's own test of a unit's bounding sphere ``sp`` = (centre relative
// to the scene centre, radius with slack; accel/compact.py::unit_spheres)
// against its ray, from the Plücker features f = [d, o x d, o, 1] (unit d):
// with q = centre - o, the ray passes the sphere when |q x d|² <= r² and
// t* + r >= 0 for t* = q.d, and every hit inside the sphere has t >= t* - r
// (``entry``, clamped at 0).  Unfused multiplies and adds in the order of
// lane_unit_flags_plain, so the two agree bit for bit.  The slack in r
// (2e-4 of the scene's scale) is far above the rounding of this test and
// of the triangle planes: a lane skips a unit only if none of its
// triangles can pass.
__device__ __forceinline__ bool lane_passes(const float4 sp, const float* f, float& entry) {
  const float qx = __fsub_rn(sp.x, f[6]);
  const float qy = __fsub_rn(sp.y, f[7]);
  const float qz = __fsub_rn(sp.z, f[8]);
  const float ts = __fadd_rn(__fadd_rn(__fmul_rn(qx, f[0]), __fmul_rn(qy, f[1])),
                             __fmul_rn(qz, f[2]));
  const float wx = __fsub_rn(__fmul_rn(qy, f[2]), __fmul_rn(qz, f[1]));
  const float wy = __fsub_rn(__fmul_rn(qz, f[0]), __fmul_rn(qx, f[2]));
  const float wz = __fsub_rn(__fmul_rn(qx, f[1]), __fmul_rn(qy, f[0]));
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)),
                             __fmul_rn(wz, wz));
  entry = fmaxf(__fsub_rn(ts, sp.w), 0.f);
  return sp.w >= 0.f && d2 <= __fmul_rn(sp.w, sp.w) && __fadd_rn(ts, sp.w) >= 0.f;
}

// The walk both compact sweeps share, for the kLanes lanes of a row group
// that one block takes (the group's slice is walked by kGroup / kLanes
// blocks, each for its own lanes):
//  * culling per lane: for each item every lane tests its own ray against
//    the unit's sphere (lane_passes) and wants the unit only if it is open
//    (live and, for the any-hit, not yet blocked) and its reach — the
//    closest hit's best t, the segment's range, widened by kSkipMargin —
//    reaches its own entry distance and the item's tn.  A lane whose reach
//    is below the item's tn is finished for good (tn rises along the
//    slice); the block leaves the slice once every lane is finished,
//    blocked or dead, and stages no unit that no lane wants;
//  * two ways through a staged 64-triangle tile, chosen per warp by the
//    number of its lanes that want it.  From kLock on, every wanting lane
//    sweeps the tile against its own ray.  Below, the warp turns round and
//    takes one wanting ray at a time — its features (and range) broadcast
//    by shuffle, each thread two of the tile's triangles — so a warp does
//    the work of the lanes that want the unit, not of all 32: the closest
//    hit reduces the warp's nearest hit and hands it to the ray's lane, the
//    any-hit settles the segment with one __any_sync;
//  * operands packed and aligned: a unit's triangles are one contiguous
//    block of the packed table (5,120 bytes a 64-triangle tile), copied with
//    16-byte cp.async into one of two buffers — the next wanted tile's copy
//    is in flight while this one is swept — and read as five LDS.128 per
//    triangle (consecutive threads' triangles 80 bytes apart: no bank
//    conflict).  A merged unit (g > 1) is walked tile by tile.
// Neither walk is in id order, so the closest hit keeps the lower id of a
// tie explicitly.  A lane with a negative range is dead: its features are
// zero, so no triangle passes, it wants nothing and it returns a miss
// (closest hit) or unblocked (any-hit).
template <bool kAnyHit, int kLanes, int kLock>
__device__ __forceinline__ void compact_sweep(
    const float4* __restrict__ packed, int num_tris, int unit_tris,
    const float4* __restrict__ spheres, const float* __restrict__ feats,
    const float* __restrict__ range, int n, const int* __restrict__ items,
    const float* __restrict__ item_tn, const int* __restrict__ offsets,
    int* __restrict__ out, float* __restrict__ dist_out) {
  static_assert(kGroup % kLanes == 0 && kLanes % 32 == 0,
                "a block is whole warps of a row group");
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float4 s[2][kCluster * kPackVec];
  const int row = blockIdx.x / (kGroup / kLanes);
  const int ray = blockIdx.x * kLanes + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = ray < n && range[ray] >= 0.f;
  float f[10];
  load_feats(f, feats, ray, live);
  // the closest hit's best t so far and its id; the any-hit's range
  float best = kAnyHit && live ? range[ray] : kFltMax;
  int best_id = -1;
  bool open = live;  // the any-hit closes a lane once its segment is blocked
  const int end = offsets[row + 1];

  // whether this lane wants item w / is not yet finished at it
  auto wants = [&](int w) {
    const float reach = best * kSkipMargin;
    float entry;
    const bool pass = lane_passes(spheres[items[w]], f, entry);
    return open && reach >= item_tn[w] && pass && reach >= entry;
  };
  // the first item from w on that some lane of the block wants; ``end``
  // once every lane is finished.  Block-uniform; at least one barrier when
  // w < end.
  auto scan = [&](int w) {
    for (; w < end; ++w) {
      if (__syncthreads_or(wants(w))) return w;
      if (!__syncthreads_or(open && best * kSkipMargin >= item_tn[w])) return end;
    }
    return end;
  };
  auto stage = [&](int buf, int w, int chunk) {
    const int lo = items[w] * unit_tris + chunk * kCluster;
    const int hi = min(items[w] * unit_tris + unit_tris, num_tris);
    stage_packed(s[buf], packed, lo, min(kCluster, hi - lo), threadIdx.x, kLanes);
  };
  auto take = [&](float tt, int id) {  // ties to the lower id
    if (tt < best || (tt == best && id < best_id)) {
      best = tt;
      best_id = id;
    }
  };
  // the segment of range tm is blocked at these planes
  auto blocks = [](const Planes& p, float tm) {
    return fminf(fminf(p.v, p.tdd), tm * p.sd - p.tdd) >= 0.f;
  };

  int w = scan(offsets[row]);
  int chunk = 0;  // the 64-triangle tile of unit items[w] in flight
  int buf = 0;
  if (w < end) stage(0, w, 0);
  cp_async_commit();
  while (w < end) {
    const int base = items[w] * unit_tris + chunk * kCluster;
    const int hi = min(items[w] * unit_tris + unit_tris, num_tris);
    // the tile after this one; the barrier (scan's, or the explicit one)
    // orders the last sweep of the other buffer before its restaging
    int nw = w, nchunk = chunk + 1;
    if (base + kCluster < hi) {
      __syncthreads();
    } else {
      nw = scan(w + 1);
      nchunk = 0;
    }
    if (nw < end) stage(buf ^ 1, nw, nchunk);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of the current tile has landed
    __syncthreads();     // and everyone's
    const int cnt = min(kCluster, hi - base);
    const float4* tile = s[buf];
    unsigned wanting = __ballot_sync(kFull, wants(w));
    if (__popc(wanting) >= kLock) {
      // every lane against its own ray
      if constexpr (kAnyHit) {
        if ((wanting >> lane) & 1u) {
#pragma unroll 4
          for (int j = 0; j < cnt; ++j) {
            if (blocks(planes(load_packed(tile + j * kPackVec), f), best)) {
              open = false;
              break;
            }
          }
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const Planes p = planes(load_packed(tile + j * kPackVec), f);
          if (fminf(p.v, p.tdd) >= 0.f) take(__fdiv_rn(p.tdd, p.sd), base + j);
        }
      }
    } else {
      // one wanting ray at a time, the warp's threads across its triangles
      while (wanting) {
        const int owner = __ffs(wanting) - 1;
        wanting &= wanting - 1;
        float g[10];
#pragma unroll
        for (int k = 0; k < 10; ++k) g[k] = __shfl_sync(kFull, f[k], owner);
        if constexpr (kAnyHit) {
          const float tm = __shfl_sync(kFull, best, owner);
          bool hit = false;
          for (int j = lane; j < cnt; j += 32) {
            hit |= blocks(planes(load_packed(tile + j * kPackVec), g), tm);
          }
          if (__any_sync(kFull, hit) && lane == owner) open = false;
        } else {
          float tb = kFltMax;
          int ib = -1;
          for (int j = lane; j < cnt; j += 32) {  // ids rise: strict < keeps the lower
            const Planes p = planes(load_packed(tile + j * kPackVec), g);
            if (fminf(p.v, p.tdd) >= 0.f) {
              const float tt = __fdiv_rn(p.tdd, p.sd);
              if (tt < tb) {
                tb = tt;
                ib = base + j;
              }
            }
          }
          if (__any_sync(kFull, ib >= 0)) {
            // the warp's nearest hit, ties to the lower id (-1, no hit, is
            // the largest id unsigned and t = FLT_MAX: it never wins)
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const float to = __shfl_xor_sync(kFull, tb, o);
              const int io = __shfl_xor_sync(kFull, ib, o);
              if (to < tb || (to == tb && (unsigned)io < (unsigned)ib)) {
                tb = to;
                ib = io;
              }
            }
            if (lane == owner) take(tb, ib);
          }
        }
      }
    }
    w = nw;
    chunk = nchunk;
    buf ^= 1;
  }
  cp_async_wait<0>();
  if (ray >= n) return;
  if constexpr (kAnyHit) {
    out[ray] = live && !open;
  } else {
    out[ray] = best < kFltMax ? best_id : -1;
    dist_out[ray] = best;
  }
}

// Replaces _plucker_compact_kernel (radish_pt_tpu/accel/pallas_kernels.py),
// the closest hit of every primary and extension ray above 131,072
// triangles.
// Bound on the card: instruction throughput, ~40 instructions per (ray,
// triangle) pair around the planes' 26 f32 operations — over the pairs the
// data needs, which are far fewer than the row group's: 256 bounce rays
// point everywhere, so a row group flags half of the scene's units while
// one ray passes a few.  The walk (compact_sweep) culls per lane and
// sweeps one wanting ray at a time where few lanes of a warp want a unit
// (bounce rays: three of a warp's 32 on average).
__global__ void __launch_bounds__(kBlockLanes)
compact_closest_hit_kernel(const float4* __restrict__ packed, int num_tris, int unit_tris,
                           const float4* __restrict__ spheres,
                           const float* __restrict__ feats, const float* __restrict__ tmax,
                           int n, const int* __restrict__ items,
                           const float* __restrict__ item_tn,
                           const int* __restrict__ offsets, int* __restrict__ prim_out,
                           float* __restrict__ dist_out) {
  compact_sweep<false, kBlockLanes, kLockstep>(packed, num_tris, unit_tris, spheres, feats,
                                               tmax, n, items, item_tn, offsets, prim_out,
                                               dist_out);
}

// Replaces _plucker_compact_occl_kernel (radish_pt_tpu/accel/
// pallas_kernels.py), the any-hit test of every NEE shadow segment above
// 131,072 triangles.
// Bound on the card: as the closest hit, minus the division, over each
// lane's own units within its range.  Most segments are never blocked (on
// teapot 38,236 of 617,239 live ones), so the early exit alone settles
// little: the walk (compact_sweep) wants a unit for a lane only if its
// own segment can reach the unit's sphere, finishes a lane once its range
// is below the items' tn, and sweeps one wanting segment at a time where
// few lanes of a warp want a unit.  A segment of negative range (a masked
// lane) is settled from the start and never blocked.
__global__ void __launch_bounds__(kOcclLanes)
compact_occlusion_kernel(const float4* __restrict__ packed, int num_tris, int unit_tris,
                         const float4* __restrict__ spheres,
                         const float* __restrict__ feats, const float* __restrict__ tm,
                         int n, const int* __restrict__ items,
                         const float* __restrict__ item_tn,
                         const int* __restrict__ offsets, int* __restrict__ occ_out) {
  compact_sweep<true, kOcclLanes, kOcclLockstep>(packed, num_tris, unit_tris, spheres, feats,
                                                 tm, n, items, item_tn, offsets, occ_out,
                                                 nullptr);
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

int compact_closest_hit(const float* packed, int num_tris, int unit_tris,
                        const float* spheres, const float* feats, const float* tmax, int n,
                        const int* items, const float* item_tn, const int* offsets,
                        int rows, int* prim_out, float* dist_out, void* stream) {
  compact_closest_hit_kernel
      <<<rows * (kGroup / kBlockLanes), kBlockLanes, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, unit_tris,
      reinterpret_cast<const float4*>(spheres), feats, tmax, n, items, item_tn, offsets,
      prim_out, dist_out);
  return (int)cudaGetLastError();
}

int compact_occlusion(const float* packed, int num_tris, int unit_tris,
                      const float* spheres, const float* feats, const float* tm, int n,
                      const int* items, const float* item_tn, const int* offsets, int rows,
                      int* occ_out, void* stream) {
  compact_occlusion_kernel
      <<<rows * (kGroup / kOcclLanes), kOcclLanes, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, unit_tris,
      reinterpret_cast<const float4*>(spheres), feats, tm, n, items, item_tn, offsets,
      occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
