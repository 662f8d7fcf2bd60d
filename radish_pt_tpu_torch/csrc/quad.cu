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
// Layout: one block per 128-lane mask row.  The row's cluster mask (int32
// words, bit j of word w = cluster 32w+j) is block-uniform, so the block
// walks its set bits together and stages each flagged cluster's forms in
// shared memory; without a mask the block sweeps every triangle.
//  * shadow test: one thread per ray, 64 triangles a tile (6 x 28 floats a
//    triangle, 43,008 bytes), every thread evaluating the tile against
//    its own ray's 27 features, held in registers;
//  * closest hit: only the 63 coefficients of q1..q5 that can be non-zero,
//    from the packed table c[T][64] (accel/quad.py::numpy_quad_packed),
//    kRays rays a thread, 32 triangles a tile, two tiles in flight.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kRow = 128;       // threads per block == lanes per mask row
constexpr int kTile = 64;       // triangles staged per shared-memory tile
constexpr int kFeats = 28;      // floats per feature / form row (27 live)
constexpr int kVec = kFeats / 4;  // float4 per row
constexpr int kStored = 6;      // forms stored per triangle
constexpr int kLiveVec = 16;    // float4 per packed triangle (63 live terms)
constexpr int kLiveTile = 32;   // packed triangles per closest-hit tile
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
constexpr float kEps2 = 1.1920929e-07f * 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;

// Stage triangles [base, base + n) as their first P forms.
template <int P>
__device__ __forceinline__ void stage(float4* s, const float4* __restrict__ coeffs,
                                      int base, int n) {
  constexpr int per = P * kVec;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int j = i / per;
    s[i] = coeffs[(size_t)(base + j) * (kStored * kVec) + (i - j * per)];
  }
}

// The P forms of staged triangle s for features f.
template <int P>
__device__ __forceinline__ void forms(const float4* s, const float* f, float* q) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float4 c = s[p * kVec + k];
      acc = fmaf(c.x, f[4 * k], acc);
      acc = fmaf(c.y, f[4 * k + 1], acc);
      acc = fmaf(c.z, f[4 * k + 2], acc);
      if (k + 1 < kVec) acc = fmaf(c.w, f[4 * k + 3], acc);  // not slot 27
    }
    q[p] = acc;
  }
}

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

// One thread's shadow sweep of triangles [lo, hi); returns true once every
// lane of the block is blocked (the row is done).
__device__ __forceinline__ bool occlusion_sweep(float4* s, const float4* __restrict__ coeffs,
                                                int lo, int hi, const float* f, int& occ) {
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    // also orders the previous tile's reads before the restage
    if (__syncthreads_and(occ)) return true;
    stage<kStored>(s, coeffs, base, cnt);
    __syncthreads();
    if (!occ) {
      for (int j = 0; j < cnt; ++j) {
        float q[kStored];
        forms<kStored>(s + j * kStored * kVec, f, q);
        const float m = fminf(fminf(fminf(q[0], q[1]), fminf(q[2], q[3])),
                              fminf(q[4], q[5]));
        if (m >= 0.f) {
          occ = 1;
          break;
        }
      }
    }
  }
  return false;
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

// Replaces _quad_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py), the
// any-hit test of every NEE shadow segment on the quad engine.
// Bound on the card: f32 FMA throughput, 6 forms x 27 terms = 162 fused
// multiply-adds per pair (318 flops).  A thread stops testing once its
// segment is blocked, and the block leaves its cluster walk as soon as
// every lane of the row is blocked (one __syncthreads_and per staged
// tile).  A zero-length segment has all-zero features: every form is 0,
// so the first triangle swept blocks it, as in the reference.
__global__ void __launch_bounds__(kRow)
quad_occlusion_kernel(const float4* __restrict__ coeffs, int num_tris, int sub,
                      const float4* __restrict__ feats, int n,
                      const int* __restrict__ mask, int n_words, int* __restrict__ occ_out) {
  __shared__ float4 s[kTile * kStored * kVec];
  const int ray = blockIdx.x * kRow + threadIdx.x;
  const bool live = ray < n;
  float f[kFeats];
  load_feats(f, feats, ray, live);
  int occ = live ? 0 : 1;  // padding lanes count as done for the row exit
  if (mask == nullptr) {
    occlusion_sweep(s, coeffs, 0, num_tris, f, occ);
  } else {
    const int* row = mask + (size_t)blockIdx.x * n_words;
    bool done = false;
    for (int w = 0; w < n_words && !done; ++w) {
      unsigned bits = (unsigned)row[w];
      while (bits && !done) {
        const int c = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        done = occlusion_sweep(s, coeffs, c * sub, min((c + 1) * sub, num_tris), f, occ);
      }
    }
  }
  if (live) occ_out[ray] = occ;
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

int quad_occlusion(const float* coeffs, int num_tris, int sub, const float* feats, int n,
                   const int* mask, int n_words, int* occ_out, void* stream) {
  const int blocks = (n + kRow - 1) / kRow;
  quad_occlusion_kernel<<<blocks, kRow, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(coeffs), num_tris, sub,
      reinterpret_cast<const float4*>(feats), n, mask, n_words, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
