// The sweep with triangles across a warp's threads and its rays one at a
// time, shared by the Plücker kernels (plucker.cu) and the band kernels
// (band.cu).
//
// A block walks the tiles of the clusters some culling group of it flags,
// in cluster id order (TileWalk); each tile's triangles come from the packed
// table through cp.async into one of two shared-memory buffers.  Inside a
// tile a thread takes kTris triangles of a pass into registers (five
// LDS.128 each, 80 bytes apart across the warp: no bank conflict) and the
// warp's rays go by one at a time, a ray's record (its ten features and its
// running result, 48 bytes of shared memory) read at one address by the
// whole warp: 3 loads for kTris pairs, where a sweep with rays across the
// threads moves a triangle's 80 bytes to every lane for every pair and is
// bound by the shared-memory pipe.  Which rays go by is the caller's
// choice (a ballot a tile): a ray left out costs nothing.

#pragma once

#include <cuda_runtime.h>

#include "plucker_planes.cuh"

namespace {

constexpr int kRecVec = 3;  // float4 per ray record
constexpr unsigned kWarpAll = 0xffffffffu;

// The calling thread's ray record: features f[0:10], then two words of the
// ray's running result.
__device__ __forceinline__ void write_record(float4* rec, const float* f, float r0, float r1) {
  rec[0] = make_float4(f[0], f[1], f[2], f[3]);
  rec[1] = make_float4(f[4], f[5], f[6], f[7]);
  rec[2] = make_float4(f[8], f[9], r0, r1);
}

// The calling thread's kTris triangles of a pass that starts at triangle
// ``p0`` of a staged tile of ``cnt``: triangle p0 + 32k + lane; past the
// end, a zero triangle (det = 0: it never passes).
template <int kTris>
__device__ __forceinline__ void load_pass(Packed* tri, const float4* tile, int p0, int cnt) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kTris; ++k) {
    const int j = p0 + 32 * k + (threadIdx.x & 31);
    if (j < cnt) {
      tri[k] = load_packed(tile + j * kPackVec);
    } else {
      tri[k] = Packed{zero, zero, zero, zero, zero};
    }
  }
}

// The block's walk: the tiles of kTile triangles (a cluster of ``sub``
// triangles is ceil(sub / kTile) of them) of the clusters some group of the
// block flags, clusters in id order, block-uniform.  ``next`` takes the
// block's union word w as ``word(w)`` (bit j: cluster 32w + j).
template <int kTile>
struct TileWalk {
  int n_words, sub, num_tris;
  int w = -1, c = -1, base = 0, hi = 0;
  unsigned bits = 0;

  template <class Word>
  __device__ __forceinline__ bool next(const Word& word) {
    if (base + kTile < hi) {
      base += kTile;
      return true;
    }
    while (bits == 0) {
      if (++w >= n_words) return false;
      bits = word(w);
    }
    c = (w << 5) + __ffs(bits) - 1;
    bits &= bits - 1;
    base = c * sub;
    hi = min(base + sub, num_tris);
    return true;
  }
  __device__ __forceinline__ int count() const { return min(kTile, hi - base); }
};

// The closest hit of a staged tile (``cnt`` triangles, the first one's id
// ``base``) for the calling warp's rays in ``rays`` (a bit a lane), whose
// records (``rec``, the warp's 32) hold their best t and its id.  One vote
// a ray and pass ("does any of the warp's triangles pass?"): the common
// answer is no, and no branch is taken inside the planes; when one does,
// the warp reduces to the nearest (ties to the lower id) and one thread
// writes the record.  Ids rise with k, across the warp's threads and, in a
// walk in id order, from tile to tile: a strict < against the ray's best
// keeps the lower id on a tie.
template <int kTris>
__device__ __forceinline__ void sweep_closest_tile(float4* rec, const float4* tile, int cnt,
                                                   int base, unsigned rays) {
  constexpr int kPass = 32 * kTris;
  const int lane = threadIdx.x & 31;
  for (int p0 = 0; p0 < cnt; p0 += kPass) {
    Packed tri[kTris];
    load_pass<kTris>(tri, tile, p0, cnt);
    const int id0 = base + p0 + lane;
    for (unsigned m = rays; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const float4 ra = rec[r * kRecVec], rb = rec[r * kRecVec + 1],
                   rc = rec[r * kRecVec + 2];
      const float f[10] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w, rc.x, rc.y};
      Planes p[kTris];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kTris; ++k) {
        p[k] = planes(tri[k], f);
        any |= fminf(p[k].v, p[k].tdd) >= 0.f;
      }
      if (!__any_sync(kWarpAll, any)) continue;
      float tb = rc.z;  // the ray's best so far: only a nearer t counts
      int ib = -1;
#pragma unroll
      for (int k = 0; k < kTris; ++k) {
        if (fminf(p[k].v, p[k].tdd) >= 0.f) {
          const float t = __fdiv_rn(p[k].tdd, p[k].sd);
          if (t < tb) {
            tb = t;
            ib = id0 + 32 * k;
          }
        }
      }
      if (__any_sync(kWarpAll, ib >= 0)) {
        // the warp's nearest, ties to the lower id (-1, no candidate, is
        // the largest id unsigned, and its t is the old best: it never wins)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float to = __shfl_xor_sync(kWarpAll, tb, o);
          const int io = __shfl_xor_sync(kWarpAll, ib, o);
          if (to < tb || (to == tb && (unsigned)io < (unsigned)ib)) {
            tb = to;
            ib = io;
          }
        }
        if (lane == 0) rec[r * kRecVec + 2] = make_float4(rc.x, rc.y, tb, __int_as_float(ib));
        __syncwarp();
      }
    }
  }
}

// The any-hit of a staged tile (``cnt`` triangles) for the calling warp's
// open segments in ``rays`` (a bit a lane), whose records (``rec``) hold
// their range in the third word: returns the segments one of the tile's
// triangles blocks.  One vote a segment and pass; a segment blocked in one
// pass goes by no later pass.
template <int kTris>
__device__ __forceinline__ unsigned sweep_any_tile(const float4* rec, const float4* tile,
                                                   int cnt, unsigned rays) {
  constexpr int kPass = 32 * kTris;
  unsigned blocked_rays = 0;
  for (int p0 = 0; p0 < cnt && rays != 0; p0 += kPass) {
    Packed tri[kTris];
    load_pass<kTris>(tri, tile, p0, cnt);
    for (unsigned m = rays; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const float4 ra = rec[r * kRecVec], rb = rec[r * kRecVec + 1], rc = rec[r * kRecVec + 2];
      const float f[10] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w, rc.x, rc.y};
      const float tm = rc.z;
      bool blocked = false;
#pragma unroll
      for (int k = 0; k < kTris; ++k) {
        const Planes p = planes(tri[k], f);
        blocked |= fminf(fminf(p.v, p.tdd), tm * p.sd - p.tdd) >= 0.f;
      }
      if (__any_sync(kWarpAll, blocked)) {
        rays &= ~(1u << r);
        blocked_rays |= 1u << r;
      }
    }
  }
  return blocked_rays;
}

}  // namespace
