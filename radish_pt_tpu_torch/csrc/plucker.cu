// Plücker closest-hit and shadow sweeps for Hopper (sm_90a).
//
// Both kernels evaluate the decision planes of plucker_planes.cuh: the
// closest hit keeps the exact minimum t (ties to the lower id), the shadow
// test stops at the first blocking triangle.
//
// The unit of culling is the warp: 32 consecutive lanes (rays).
//  1. Each warp runs the slab test of slab_cull.cuh on its own 32 rays
//     against every cluster's box and votes its own cluster words (bit j of
//     word w = cluster 32w+j) into shared memory: no prepass, no mask in
//     device memory.
//  2. The block walks the union of its warps' words in id order.  Each
//     flagged cluster's triangles come from the packed table (80 bytes a
//     triangle) in tiles of kSweepTile, copied with 16-byte cp.async into
//     one of two buffers: the next tile lands while this one is swept, one
//     block barrier a tile.
//  3. A warp sweeps a staged tile only if its own bit is set (a
//     warp-uniform branch), triangles across its threads (ray_sweep.cuh,
//     shared with the band kernels): each thread
//     takes kTris triangles of the tile into registers (five LDS.128 each,
//     80 bytes apart across the warp: no bank conflict), then the warp's
//     rays go by one at a time, a ray's record (its ten features and its
//     running result, 48 bytes in shared memory) read at one address by the
//     whole warp.  A sweep with rays across the threads moves a triangle's
//     80 bytes to every lane for every pair and is bound by the
//     shared-memory pipe at a quarter of the f32 rate; this one moves 48
//     bytes a lane for kTris pairs.  A ray's result changes only when some
//     thread's triangle passes: then the warp reduces to the nearest
//     (ties to the lower id) and one thread writes the record.
//  4. Only the rays that can gain from a tile go by: each lane tests its
//     own ray against the tile's cluster (slab_cull.cuh: slab_reach, the
//     box grown by a slack, entered no later than the ray's best t so far
//     or its segment's range) and the warp loops over the ballot.  A ray
//     left out costs nothing here, where a masked lane of a sweep with rays
//     across the threads costs its slot; dead lanes and settled segments
//     drop out the same way.  The test is conservative, so no result moves.
// Without cluster boxes the whole table is one cluster that every warp
// sweeps, and step 1 is skipped.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"
#include "ray_sweep.cuh"
#include "slab_cull.cuh"

namespace {

// The kernels' shape: lanes a block (whole warps), triangles a staged tile
// and triangles a thread holds at a time.  -DPLUCKER_BLOCK_LANES /
// -DPLUCKER_TILE / -DPLUCKER_TRIS build another shape for a measurement
// (radish_pt_tpu_torch/tune.py).
#ifndef PLUCKER_BLOCK_LANES
#define PLUCKER_BLOCK_LANES 64
#endif
#ifndef PLUCKER_TILE
#define PLUCKER_TILE 128
#endif
#ifndef PLUCKER_TRIS
#define PLUCKER_TRIS 4
#endif
constexpr int kBlockLanes = PLUCKER_BLOCK_LANES;
constexpr int kWarps = kBlockLanes / 32;
constexpr int kSweepTile = PLUCKER_TILE;
constexpr int kTris = PLUCKER_TRIS;
constexpr int kPass = 32 * kTris;  // triangles a warp holds at a time
constexpr int kMaxWords = 32;      // 1,024 clusters (accel/plucker.py::MAX_CLUSTERS)
// A ray passes over a cluster whose box, grown by kSkipSlack times the
// scene's scale, it enters beyond its reach widened by kSkipMargin
// (accel/plucker.py: SKIP_SLACK, SKIP_MARGIN).
constexpr float kSkipSlack = 2e-4f;
constexpr float kSkipMargin = 1.f + 1e-4f;
static_assert(kBlockLanes % 32 == 0 && kBlockLanes >= 32, "a block is whole warps");
static_assert(kSweepTile % kPass == 0, "a tile is whole passes");

// Step 1 for the calling warp: its cluster words into words[0:n_words].
// ``sweeps`` false (a warp with no ray to settle) flags nothing.  Returns
// the slack of the per-ray test (0 without boxes).
__device__ __forceinline__ float vote_words(unsigned* words, const float* __restrict__ bounds,
                                            int n_clusters, const SlabRay& r, bool sweeps) {
  const int lane = threadIdx.x & 31;
  if (bounds == nullptr) {
    if (lane == 0) words[0] = sweeps ? 1u : 0u;
  } else if (sweeps) {
    return kSkipSlack * warp_cluster_words(words, bounds, n_clusters, r);
  } else if (lane < ((n_clusters + 31) >> 5)) {
    words[lane] = 0u;
  }
  return 0.f;
}

// The rays of the calling warp, of those in ``rays`` (a bit a lane), that
// can meet cluster ``c``'s grown box within ``reach`` (the calling lane's
// own).  Without boxes every ray of ``rays`` sweeps.
__device__ __forceinline__ unsigned rays_in_reach(unsigned rays, const float* __restrict__ bounds,
                                                  int c, const SlabRay& r, float slack,
                                                  float reach) {
  if (bounds == nullptr) return rays;
  return rays & __ballot_sync(kFullWarp, slab_reach(r, bounds + (size_t)c * 6, slack, reach));
}

// Step 2's walk: the block's union word w is the OR of its warps' words.
struct WarpWords {
  unsigned (*words)[kMaxWords];
  __device__ __forceinline__ unsigned operator()(int w) const {
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) bits |= words[k][w];
    return bits;
  }
  // whether the calling warp flags cluster c
  __device__ __forceinline__ bool mine(int c) const {
    return (words[threadIdx.x >> 5][c >> 5] >> (c & 31)) & 1u;
  }
};

// Replaces _plucker_kernel (radish_pt_tpu/accel/pallas_kernels.py) and the
// slab-test prepass in front of it (_cluster_mask_bits), the closest hit of
// every primary and extension ray.
// Bound on the card: the f32 pipe — 26 multiplies and fused multiply-adds (41
// flops) per (ray, triangle) pair — over the pairs the culling leaves,
// once the operands stay out of the shared-memory pipe.  The design cuts
// the pairs (a warp sweeps what its 32 rays flag, not what 128 do, and a
// ray passes over the tiles it cannot gain from), keeps kTris triangles a
// thread in registers while the warp's rays go by as broadcast reads (see
// the head of the file), stages each tile once per block, and overlaps its
// copy with the sweep before it.  ``tmax`` bounds only the culling; a lane
// with a negative tmax is dead: it flags nothing, is swept by nothing and
// misses.
__global__ void __launch_bounds__(kBlockLanes)
closest_hit_kernel(const float4* __restrict__ packed, int num_tris, int sub,
                   const float* __restrict__ bounds, int n_clusters,
                   const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                   const float* __restrict__ tmax, const float* __restrict__ feats, int n,
                   int* __restrict__ prim_out, float* __restrict__ dist_out) {
  __shared__ float4 s[2][kSweepTile * kPackVec];
  __shared__ float4 recs[kWarps][32 * kRecVec];
  __shared__ unsigned words[kWarps][kMaxWords];
  const int ray = blockIdx.x * kBlockLanes + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* rec = recs[warp];
  const SlabRay sr = slab_ray(ray_o, ray_d, tmax, ray, n);
  // the warp's rays to trace, a bit a lane: not past the end, not dead
  const unsigned live = __ballot_sync(kFullWarp, ray < n && sr.tm >= 0.f);
  {
    float f[10];
    load_feats(f, feats, ray, ray < n);
    // a record's result: best t so far, and its triangle's id as bits
    write_record(rec + lane * kRecVec, f, kFltMax, __int_as_float(-1));
  }
  const float slack = vote_words(words[warp], bounds, n_clusters, sr, live != 0);
  __syncthreads();

  const WarpWords union_of{words};
  TileWalk<kSweepTile> walk{(n_clusters + 31) >> 5, sub, num_tris};
  bool more = walk.next(union_of);
  if (more) stage_packed(s[0], packed, walk.base, walk.count(), threadIdx.x, kBlockLanes);
  cp_async_commit();
  for (int buf = 0; more; buf ^= 1) {
    const int base = walk.base, cnt = walk.count(), c = walk.c;
    const bool sweep = union_of.mine(c);
    cp_async_wait<0>();  // this thread's part of the tile has landed
    // everyone's part has, and the other buffer's sweep is over
    __syncthreads();
    more = walk.next(union_of);
    if (more) {
      stage_packed(s[buf ^ 1], packed, walk.base, walk.count(), threadIdx.x, kBlockLanes);
    }
    cp_async_commit();
    if (!sweep) continue;
    // the rays that can still gain from this tile: only a nearer t counts
    const unsigned rays = rays_in_reach(live, bounds, c, sr, slack,
                                        rec[lane * kRecVec + 2].z * kSkipMargin);
    if (rays == 0) continue;
    sweep_closest_tile<kTris>(rec, s[buf], cnt, base, rays);
  }
  cp_async_wait<0>();
  __syncwarp();
  if (ray < n) {
    const float4 rc = rec[lane * kRecVec + 2];
    prim_out[ray] = rc.z < kFltMax ? __float_as_int(rc.w) : -1;
    dist_out[ray] = rc.z;
  }
}

// Replaces _plucker_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py) and
// its slab-test prepass, the any-hit test of every NEE shadow segment.
// Bound on the card: as the closest hit, minus the division and the
// running minimum.  A ray is settled once its segment is blocked, or from
// the start when its range is negative (a masked lane: no triangle can
// block it), and no tile is swept for it from then on, nor a tile whose
// cluster its own segment cannot reach: with the rays going by one at a
// time a ray left out costs nothing.  A warp whose rays are all settled
// sweeps no later tile, and the block leaves its walk once all its warps
// have (the vote rides on the tile's barrier).
__global__ void __launch_bounds__(kBlockLanes)
occlusion_kernel(const float4* __restrict__ packed, int num_tris, int sub,
                 const float* __restrict__ bounds, int n_clusters,
                 const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                 const float* __restrict__ tm_in, const float* __restrict__ feats, int n,
                 int* __restrict__ occ_out) {
  __shared__ float4 s[2][kSweepTile * kPackVec];
  __shared__ float4 recs[kWarps][32 * kRecVec];
  __shared__ unsigned words[kWarps][kMaxWords];
  const int ray = blockIdx.x * kBlockLanes + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* rec = recs[warp];
  const SlabRay sr = slab_ray(ray_o, ray_d, tm_in, ray, n);
  {
    float f[10];
    load_feats(f, feats, ray, ray < n);
    // a record's result: the segment's range
    write_record(rec + lane * kRecVec, f, sr.tm, 0.f);
  }
  // the warp's rays still to settle, and those found blocked, a bit a lane
  unsigned open = __ballot_sync(kFullWarp, ray < n && sr.tm >= 0.f);
  unsigned blocked_rays = 0;
  const float slack = vote_words(words[warp], bounds, n_clusters, sr, open != 0);
  __syncthreads();

  const WarpWords union_of{words};
  TileWalk<kSweepTile> walk{(n_clusters + 31) >> 5, sub, num_tris};
  bool more = walk.next(union_of);
  if (more) stage_packed(s[0], packed, walk.base, walk.count(), threadIdx.x, kBlockLanes);
  cp_async_commit();
  for (int buf = 0; more; buf ^= 1) {
    const int cnt = walk.count(), c = walk.c;
    const bool sweep = union_of.mine(c);
    cp_async_wait<0>();
    // the tile's barrier, and whether every warp of the block is done
    if (__syncthreads_and(open == 0)) break;
    more = walk.next(union_of);
    if (more) {
      stage_packed(s[buf ^ 1], packed, walk.base, walk.count(), threadIdx.x, kBlockLanes);
    }
    cp_async_commit();
    if (!sweep) continue;
    // the open rays whose segment reaches this tile's cluster
    const unsigned rays = rays_in_reach(open, bounds, c, sr, slack, sr.tm * kSkipMargin);
    if (rays == 0) continue;
    const unsigned hit = sweep_any_tile<kTris>(rec, s[buf], cnt, rays);
    open &= ~hit;
    blocked_rays |= hit;
  }
  cp_async_wait<0>();
  if (ray < n) occ_out[ray] = (blocked_rays >> lane) & 1u;
}

}  // namespace

extern "C" {

int plucker_closest_hit(const float* packed, int num_tris, int sub, const float* bounds,
                        int n_clusters, const float* ray_o, const float* ray_d,
                        const float* tmax, const float* feats, int n, int* prim_out,
                        float* dist_out, void* stream) {
  const int blocks = (n + kBlockLanes - 1) / kBlockLanes;
  closest_hit_kernel<<<blocks, kBlockLanes, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, sub, bounds, n_clusters, ray_o,
      ray_d, tmax, feats, n, prim_out, dist_out);
  return (int)cudaGetLastError();
}

int plucker_occlusion(const float* packed, int num_tris, int sub, const float* bounds,
                      int n_clusters, const float* ray_o, const float* ray_d,
                      const float* tm, const float* feats, int n, int* occ_out,
                      void* stream) {
  const int blocks = (n + kBlockLanes - 1) / kBlockLanes;
  occlusion_kernel<<<blocks, kBlockLanes, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, sub, bounds, n_clusters, ray_o,
      ray_d, tm, feats, n, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
