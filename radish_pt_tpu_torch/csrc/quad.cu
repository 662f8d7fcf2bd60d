// Quadratic-form closest-hit and shadow sweeps for Hopper (sm_90a): the
// opt-in quad engine.
//
// Each of Möller–Trumbore's decision quantities, multiplied through by det,
// is a linear form in 27 ray monomials f (d⊗d sym, m⊗d, o⊗d, d; o centred
// on the scene, m = o x d) with build-time per-triangle coefficients
// c[T][6][28] (slot 27, the constant monomial, always has coefficient 0):
//   q1 = bx·det, q2 = by·det, q3 = det² - (bx + by)·det,
//   q4 = det² - eps²·|d|², q5 = t·det·det, q6 = det² - t·det·det.
//   closest hit:  min(q1..q5) >= 0, t = q5 / (q4 + eps²)
//   shadow:       min(q1..q6) >= 0 over segments with t in [0, 1]
// Every form is summed over its monomials in order, one fmaf per term from
// 0, as accel/quad.py::forms sums it: kernel and plain version agree to
// the ulp (the same winners on every lane at 800x800).
//
// Layout: one block per 128-lane row, walking the clusters its row flags
// together (every triangle without cluster boxes):
//  * closest hit: the row's mask words from the prepass
//    accel/plucker.py::cluster_mask_words; only the 63 coefficients of
//    q1..q5 that can be non-zero, from the packed table c[T][64]
//    (accel/quad.py::numpy_quad_packed), kRays rays a thread, 32 triangles a
//    tile, two tiles in flight;
//  * shadow test: the row votes its own words from the cluster boxes and
//    the segments (slab_cull.cuh), then sweeps the 81 live coefficients of
//    q1..q6 from the packed table c[T][84] (numpy_quad_occl_packed), each
//    segment passing over the clusters its own grown box cannot reach.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "slab_cull.cuh"

namespace {

constexpr int kRow = 128;       // lanes per row: a block's
constexpr int kFeats = 28;      // floats per feature row (27 live)
constexpr int kLive = 27;       // monomials
constexpr int kVec = kFeats / 4;  // float4 per feature row
constexpr int kStored = 6;      // forms per triangle: q1..q6
constexpr int kLiveVec = 16;    // float4 per packed triangle (63 live terms)
constexpr int kLiveTile = 32;   // packed triangles per tile
constexpr int kOcclLive = 81;   // live terms of q1..q6
constexpr int kOcclVec = 21;    // float4 per packed shadow triangle
// The closest-hit kernel's shape: rays a thread carries (1, 2 or 4) and the
// resident blocks per SM asked of the compiler, which caps its registers
// (8 blocks of 64 threads: 128 registers).  -DQUAD_RAYS / -DQUAD_MIN_BLOCKS
// build another shape for a measurement (radish_pt_tpu_torch/tune.py).
#ifndef QUAD_RAYS
#define QUAD_RAYS 2
#endif
#ifndef QUAD_MIN_BLOCKS
#define QUAD_MIN_BLOCKS 8
#endif
constexpr int kRays = QUAD_RAYS;
// The shadow kernel's resident blocks asked of the compiler: 4 (128
// registers) won the race (tune.py, teapot's bounce-1 segments, H100 80GB
// HBM3 at 700 W: 0.771-0.774 ms; uncapped, 136 registers, 0.807-0.812).
// -DQUAD_OCCL_MIN_BLOCKS builds another for a measurement.
#ifndef QUAD_OCCL_MIN_BLOCKS
#define QUAD_OCCL_MIN_BLOCKS 4
#endif
constexpr float kEps2 = 1.1920929e-07f * 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;
// A segment passes over a cluster whose box, grown by kSkipSlack times the
// scene's scale, it enters beyond t = kSkipMargin of its unit parameter
// (accel/plucker.py: SKIP_SLACK, SKIP_MARGIN).
constexpr float kSkipSlack = 2e-4f;
constexpr float kSkipMargin = 1.f + 1e-4f;

__device__ __forceinline__ void load_feats(float* f, const float4* __restrict__ feats,
                                           int ray, bool live) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float4 v = live ? feats[(size_t)ray * kVec + k] : make_float4(0.f, 0.f, 0.f, 0.f);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// The block's walk over the triangles of its row's flagged clusters (every
// triangle without a mask), in tiles of at most kLiveTile.
struct TileWalk {
  const int* row;  // the row's mask words, or nullptr
  int n_words, sub, num_tris;
  int w, pos, hi;
  unsigned bits;

  __device__ TileWalk(const int* row_, int n_words_, int sub_, int num_tris_)
      : row(row_), n_words(n_words_), sub(sub_), num_tris(num_tris_), w(-1), pos(0),
        hi(row_ == nullptr ? num_tris_ : 0), bits(0u) {}

  __device__ bool next(int& base, int& cnt) {
    while (pos >= hi) {  // the next flagged cluster
      while (bits == 0u) {
        if (row == nullptr || ++w >= n_words) return false;
        bits = (unsigned)row[w];
      }
      const int c = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      pos = c * sub;
      hi = min(pos + sub, num_tris);
    }
    base = pos;
    cnt = min(kLiveTile, hi - pos);
    pos += cnt;
    return true;
  }
};

// Replaces _quad_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// closest hit of every primary and extension ray on the quad engine.
// Bound on the card: f32 FMA throughput.  The TPU kernel multiplied a [rays, 27]
// by a [27, 5T] matrix on its matrix unit and paid nothing for the
// structural zeros; CUDA cores pay for every term, so the design drops
// them: q1..q3 have coefficients only on d⊗d and m⊗d (15 monomials), q4 on
// d⊗d (6), q5 on o⊗d and d (12) — 63 fused multiply-adds a pair (121
// flops) instead of 135, each form still summed in monomial order from 0,
// so every value is the plain version's (a dropped term adds an exact
// zero).  The packed triangle is sixteen float4, each feeding four
// multiply-adds; a thread carries kRays rays of the row (their features
// and running minima in registers), so a staged float4 is read once for
// 4·kRays multiply-adds and the shared-memory pipe stays clear of the FMA
// pipe.  Tiles of 32 triangles (8,192 bytes) are copied with 16-byte
// cp.async into one of two buffers, the next tile in flight during this
// tile's sweep, one barrier a tile.
template <int R>
__global__ void __launch_bounds__(kRow / R, QUAD_MIN_BLOCKS)
quad_closest_hit_kernel(const float4* __restrict__ packed, int num_tris, int sub,
                        const float4* __restrict__ feats, int n,
                        const int* __restrict__ mask, int n_words,
                        int* __restrict__ prim_out, float* __restrict__ dist_out) {
  constexpr int kThreads = kRow / R;
  __shared__ float4 s[2][kLiveTile * kLiveVec];
  float f[R][kFeats], best[R];
  int best_id[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ray = blockIdx.x * kRow + r * kThreads + threadIdx.x;
    load_feats(f[r], feats, ray, ray < n);
    best[r] = kFltMax;
    best_id[r] = -1;
  }
  auto stage = [&](int buf, int base, int cnt) {
    const float4* src = packed + (size_t)base * kLiveVec;
    for (int i = threadIdx.x; i < cnt * kLiveVec; i += kThreads)
      cp_async16(&s[buf][i], src + i);
  };
  TileWalk walk(mask == nullptr ? nullptr : mask + (size_t)blockIdx.x * n_words, n_words,
                sub, num_tris);
  int base, cnt, buf = 0;
  bool have = walk.next(base, cnt);
  if (have) stage(0, base, cnt);
  cp_async_commit();
  while (have) {
    int nbase = 0, ncnt = 0;
    const bool nhave = walk.next(nbase, ncnt);
    cp_async_wait<0>();  // this thread's part of the current tile has landed
    __syncthreads();      // and everyone's; the other buffer's sweep is over
    if (nhave) stage(buf ^ 1, nbase, ncnt);
    cp_async_commit();
    for (int j = 0; j < cnt; ++j) {
      const float4* t = s[buf] + j * kLiveVec;
      float c[4 * kLiveVec];
#pragma unroll
      for (int k = 0; k < kLiveVec; ++k) {
        const float4 v = t[k];
        c[4 * k] = v.x;
        c[4 * k + 1] = v.y;
        c[4 * k + 2] = v.z;
        c[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float q1 = 0.f, q2 = 0.f, q3 = 0.f, q4 = 0.f, q5 = 0.f;
#pragma unroll
        for (int k = 0; k < 15; ++k) {  // d⊗d and m⊗d
          q1 = fmaf(c[k], f[r][k], q1);
          q2 = fmaf(c[15 + k], f[r][k], q2);
          q3 = fmaf(c[30 + k], f[r][k], q3);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) q4 = fmaf(c[45 + k], f[r][k], q4);  // d⊗d
#pragma unroll
        for (int k = 0; k < 12; ++k) q5 = fmaf(c[51 + k], f[r][15 + k], q5);  // o⊗d, d
        const float m = fminf(fminf(fminf(q1, q2), fminf(q3, q4)), q5);
        if (m >= 0.f) {
          const float tt = __fdiv_rn(q5, __fadd_rn(q4, kEps2));
          if (tt < best[r]) {  // ids rise through the walk: ties keep the lower
            best[r] = tt;
            best_id[r] = base + j;
          }
        }
      }
    }
    have = nhave;
    base = nbase;
    cnt = ncnt;
    buf ^= 1;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ray = blockIdx.x * kRow + r * kThreads + threadIdx.x;
    if (ray < n) {
      prim_out[ray] = best[r] < kFltMax ? best_id[r] : -1;
      dist_out[ray] = best[r];
    }
  }
}

// ---- the shadow test ----

// The packed shadow table's slot -> (form, monomial): q1..q3 over d⊗d and
// m⊗d (monomials 0-14), q4 over d⊗d (0-5), q5 over o⊗d and d (15-26), q6
// over d⊗d, o⊗d and d (0-5, 15-26), form by form in monomial order
// (accel/quad.py::OCCL_SLOTS).
__host__ __device__ constexpr int occl_form(int slot) {
  return slot < 15 ? 0 : slot < 30 ? 1 : slot < 45 ? 2 : slot < 51 ? 3 : slot < 63 ? 4 : 5;
}
__host__ __device__ constexpr int occl_mono(int slot) {
  return slot < 45 ? slot % 15
       : slot < 51 ? slot - 45
       : slot < 63 ? 15 + (slot - 51)
       : slot < 69 ? slot - 63
                   : 15 + (slot - 69);
}

// Float4 ``v`` of a packed shadow triangle summed into the forms q[6] of a
// segment's features f: each live term one fmaf, every form in monomial
// order from 0, as accel/quad.py::forms_live sums it.
__device__ __forceinline__ void occl_terms(const float4 c, int v, const float (&f)[kLive],
                                           float (&q)[kStored]) {
  const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int slot = 4 * v + j;
    if (slot < kOcclLive) {
      q[occl_form(slot)] = fmaf(cs[j], f[occl_mono(slot)], q[occl_form(slot)]);
    }
  }
}

__device__ __forceinline__ bool occl_blocked(const float (&q)[kStored]) {
  return fminf(fminf(fminf(q[0], q[1]), fminf(q[2], q[3])), fminf(q[4], q[5])) >= 0.f;
}

// Replaces _quad_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py) and the
// slab prepass in front of it (_cluster_mask_bits), the any-hit test of
// every NEE shadow segment on the quad engine.
// Bound on the card: the f32 pipe — the 81 live terms of q1..q6, 156 flops
// a (segment, triangle) pair — over the pairs the culling leaves.  The
// TPU kernel summed all 6 x 27 terms on its matrix unit; here every term
// costs an FMA, so the packed table keeps only the live ones (a dropped
// term adds an exact zero: every form keeps its value).  The design:
//  1. the block is one 128-lane row, a segment a thread; each warp votes
//     the slab tests of its segments (the unit-parameter segments of
//     accel/quad.py::quad_segments, range 1; padding lanes o = 0, d = 1,
//     range 0, as the prepass pads them) against every cluster box with
//     slab_cull.cuh::warp_cluster_words, ORing its words into the row's in
//     shared memory: cluster_mask_words(bounds, o, seg, 1), bit for bit;
//  2. a zero-length segment has all-zero features, so every form of every
//     triangle is 0 and it reads as blocked wherever its row sweeps a
//     triangle (the reference's quirk): it is settled from the row's words
//     up front;
//  3. the block walks the row's clusters in id order, tiles of 32 packed
//     triangles (10,752 bytes) copied with 16-byte cp.async into one of two
//     buffers, one barrier a tile, which also tells whether every segment
//     of the row is settled (then the block leaves);
//  4. a segment goes by a tile only if its own grown box test admits the
//     cluster at t = kSkipMargin (slab_reach); a warp none of whose open
//     segments is admitted skips the tile.  The skip is conservative
//     (accel/plucker.py::lane_skip_flags_plain, shown on the CPU under the
//     quad forms), so it moves no result;
//  5. a triangle a thread, its 84 coefficients in registers, the warp's
//     admitted segments going by one at a time from shared records (7
//     broadcast float4 for 81 FMAs), one __any_sync settling a segment, so
//     a segment its own box test rules out costs nothing.
__global__ void __launch_bounds__(kRow, QUAD_OCCL_MIN_BLOCKS)
quad_occlusion_kernel(const float4* __restrict__ packed, int num_tris, int sub,
                      const float* __restrict__ bounds, int n_clusters,
                      const float* __restrict__ ray_o, const float* __restrict__ seg,
                      const float4* __restrict__ feats, int n, int* __restrict__ occ_out) {
  extern __shared__ unsigned row_words[];  // the row's cluster words
  __shared__ float4 s[2][kLiveTile * kOcclVec];
  __shared__ SlabRay srs[kRow];
  __shared__ float4 recs[kRow * kVec];  // the row's segments' features, 7 float4 each
  const int n_words = bounds == nullptr ? 0 : (n_clusters + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRow + threadIdx.x;
  for (int i = threadIdx.x; i < n_words; i += kRow) row_words[i] = 0u;
  bool zero = ray < n;  // a real segment with all-zero features
  SlabRay sr = slab_ray(ray_o, seg, nullptr, ray, n);
  sr.tm = ray < n ? 1.f : 0.f;  // the unit parameter's range; padding: 0
  srs[threadIdx.x] = sr;
  {
    float fr[kFeats];
    load_feats(fr, feats, ray, ray < n);
#pragma unroll
    for (int k = 0; k < kLive; ++k) zero &= fr[k] == 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      recs[threadIdx.x * kVec + k] =
          make_float4(fr[4 * k], fr[4 * k + 1], fr[4 * k + 2], fr[4 * k + 3]);
    }
  }
  __syncthreads();  // the words are zero
  const float slack =
      bounds == nullptr ? 0.f
                        : kSkipSlack * warp_cluster_words<true>(row_words, bounds, n_clusters, sr);
  __syncthreads();
  // the row sweeps a triangle: without boxes, any; else a flagged cluster
  bool row_sweeps = bounds == nullptr && num_tris > 0;
  for (int w = 0; w < n_words; ++w) row_sweeps |= row_words[w] != 0u;
  bool open = ray < n && !zero, blocked = row_sweeps && zero;

  auto stage = [&](int buf, int base, int cnt) {
    const float4* src = packed + (size_t)base * kOcclVec;
    for (int i = threadIdx.x; i < cnt * kOcclVec; i += kRow) cp_async16(&s[buf][i], src + i);
  };
  TileWalk walk(bounds == nullptr ? nullptr : reinterpret_cast<const int*>(row_words), n_words,
                sub, num_tris);
  int base, cnt, buf = 0;
  bool have = walk.next(base, cnt);
  if (have) stage(0, base, cnt);
  cp_async_commit();
  while (have) {
    int nbase = 0, ncnt = 0;
    const bool nhave = walk.next(nbase, ncnt);
    cp_async_wait<0>();  // this thread's part of the current tile has landed
    // and everyone's, the other buffer's sweep is over, and whether every
    // segment of the row is settled
    if (__syncthreads_and(!open)) break;
    if (nhave) stage(buf ^ 1, nbase, ncnt);
    cp_async_commit();
    // the warp's open segments that reach this tile's cluster, one at a
    // time against a triangle a thread
    const bool want = open && (bounds == nullptr ||
                               slab_reach(srs[threadIdx.x], bounds + (size_t)(base / sub) * 6,
                                          slack, kSkipMargin));
    const unsigned rays = __ballot_sync(kFullWarp, want);
    if (rays != 0) {
      float4 c[kOcclVec];
      const bool valid = lane < cnt;
#pragma unroll
      for (int v = 0; v < kOcclVec; ++v) {
        c[v] = valid ? s[buf][lane * kOcclVec + v] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4* wrec = recs + (threadIdx.x & ~31) * kVec;
      for (unsigned m = rays; m; m &= m - 1) {
        const int r = __ffs(m) - 1;
        float g[kLive];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float4 x = wrec[r * kVec + k];
          g[4 * k] = x.x;
          g[4 * k + 1] = x.y;
          g[4 * k + 2] = x.z;
          if (k + 1 < kVec) g[4 * k + 3] = x.w;
        }
        float q[kStored] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int v = 0; v < kOcclVec; ++v) occl_terms(c[v], v, g, q);
        if (__any_sync(kFullWarp, valid && occl_blocked(q)) && lane == r) {
          open = false;
          blocked = true;
        }
      }
    }
    have = nhave;
    base = nbase;
    cnt = ncnt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  if (ray < n) occ_out[ray] = blocked;
}

}  // namespace

extern "C" {

int quad_closest_hit(const float* packed, int num_tris, int sub, const float* feats, int n,
                     const int* mask, int n_words, int* prim_out, float* dist_out,
                     void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  quad_closest_hit_kernel<kRays><<<blocks, kRow / kRays, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, sub,
      reinterpret_cast<const float4*>(feats), n, mask, n_words, prim_out, dist_out);
  return (int)cudaGetLastError();
}

int quad_occlusion(const float* packed, int num_tris, int sub, const float* bounds,
                   int n_clusters, const float* ray_o, const float* seg, const float* feats,
                   int n, int* occ_out, void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  const size_t smem = bounds == nullptr ? 0 : ((n_clusters + 31) >> 5) * sizeof(int);
  quad_occlusion_kernel<<<blocks, kRow, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, sub, bounds, n_clusters, ray_o, seg,
      reinterpret_cast<const float4*>(feats), n, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
