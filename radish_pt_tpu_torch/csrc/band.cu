// Banded Plücker closest-hit and shadow sweeps for Hopper (sm_90a): the
// opt-in band engine.
//
// The planes are those of plucker_planes.cuh, bit-identical to the Plücker
// kernels'.  What differs is the culling: each 128-lane row is cut into g
// bands of 128/g lanes (g a power of two, 1 to 128), a band flags the
// 64-triangle clusters any of its rays may hit (the slab test of
// slab_cull.cuh), and every lane sweeps exactly the clusters of its own
// band.  Words hold 32 clusters: bit j of word w = cluster 32w + j; cluster
// c is triangles [64c, 64c + 64), so a winner's id is 64c + its place in
// the cluster.
//
// Both kernels vote their bands' words themselves (no prepass, no mask in
// device memory) and sweep as the Plücker kernels do (ray_sweep.cuh: the
// packed table staged block-wide through cp.async into two buffers,
// triangles across a warp's threads, its rays one at a time, each ray
// passing over the clusters its own grown box cannot reach).
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker_planes.cuh"
#include "ray_sweep.cuh"
#include "slab_cull.cuh"

namespace {

constexpr int kRow = 128;  // lanes per row
constexpr int kWarp = 32;
constexpr int kCluster = 64;  // triangles per culling cluster
constexpr unsigned kFull = 0xffffffffu;

// The kernels' shape: lanes a block (64 or 128; a band of 128 lanes,
// g = 1, takes a block of 128), triangles a thread holds at a time, and
// whether the vote first tests each word's union box (two levels) or
// every cluster's box (one).  -DBAND_BLOCK_LANES / -DBAND_TRIS /
// -DBAND_TWO_LEVEL build another shape for a measurement
// (radish_pt_tpu_torch/tune.py).
#ifndef BAND_BLOCK_LANES
#define BAND_BLOCK_LANES 64
#endif
#ifndef BAND_TRIS
#define BAND_TRIS 2
#endif
#ifndef BAND_TWO_LEVEL
#define BAND_TWO_LEVEL 1
#endif
constexpr int kBlockLanes = BAND_BLOCK_LANES;
constexpr int kTris = BAND_TRIS;
constexpr bool kTwoLevel = BAND_TWO_LEVEL != 0;
static_assert(kBlockLanes == 64 || kBlockLanes == kRow, "a block is 64 or 128 lanes");
static_assert(kCluster % (32 * kTris) == 0, "a cluster is whole passes");
// A ray passes over a cluster whose box, grown by kSkipSlack times the
// scene's scale, it enters beyond its reach (best t so far, or the
// segment's range) widened by kSkipMargin
// (accel/plucker.py: SKIP_SLACK, SKIP_MARGIN).
constexpr float kSkipSlack = 2e-4f;
constexpr float kSkipMargin = 1.f + 1e-4f;

// The calling lane's band's cluster words (``band_words``, n_words long)
// and the block's union (``uni``), both zero on entry.  Each lane that
// ``votes`` (the closest hit's live lanes, the shadow sweep's real ones;
// padding lanes flag nothing) tests its own ray against each box with
// slab_hit; a band's bit is the OR over its
// lanes: __reduce_or_sync over the band's lanes of this warp (the whole
// warp from 32 lanes up), then an atomicOr into the band's shared word,
// which a band of several warps (g <= 2) ORs across them.  With kTwoLevel
// a warp first tests the box of each word's 32 clusters (``word_bounds``)
// and tests the 32 only where one of its lanes passes it.  That moves no
// bit: the slab test is monotone under box containment in f32 too —
// (bound - o) * inv rounds monotonically in the bound — so a lane that
// passes a cluster's box passes its word's box.  Returns the slack of the
// per-ray test: kSkipSlack times the boxes' largest extent along an axis.
__device__ __forceinline__ float vote_band_words(unsigned* band_words, unsigned* uni,
                                                 const float* __restrict__ bounds,
                                                 const float* __restrict__ word_bounds,
                                                 int n_clusters, const SlabRay& r, bool votes,
                                                 int band_lanes) {
  const int lane = threadIdx.x & 31;
  const int seg = min(band_lanes, kWarp);  // the band's lanes in this warp
  const unsigned seg_mask = seg == kWarp ? kFull : ((1u << seg) - 1u) << (lane & ~(seg - 1));
  const bool leader = (lane & (seg - 1)) == 0;
  const bool warp_votes = __any_sync(kFull, votes);
  float lo[3] = {kSlabFltMax, kSlabFltMax, kSlabFltMax};
  float hi[3] = {-kSlabFltMax, -kSlabFltMax, -kSlabFltMax};
  for (int w = 0; w < (n_clusters + 31) >> 5; ++w) {
    const float* wb = word_bounds + (size_t)w * 6;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = fminf(lo[k], wb[k]);
      hi[k] = fmaxf(hi[k], wb[3 + k]);
    }
    if (!warp_votes) continue;
    if (kTwoLevel && !__any_sync(kFull, votes && slab_hit(r, wb))) continue;
    const int c0 = w << 5;
    const int cnt = min(32, n_clusters - c0);
    unsigned mine = 0;
    for (int j = 0; j < cnt; ++j) {
      if (slab_hit(r, bounds + (size_t)(c0 + j) * 6)) mine |= 1u << j;
    }
    if (!votes) mine = 0;
    const unsigned word = __reduce_or_sync(seg_mask, mine);
    if (leader && word) atomicOr(band_words + w, word);
    const unsigned any = __reduce_or_sync(kFull, mine);
    if (lane == 0 && any) atomicOr(uni + w, any);
  }
  return kSkipSlack * fmaxf(fmaxf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
}

// Replaces _band_kernel (radish_pt_tpu/accel/pallas_kernels.py) and the
// band-mask prepass in front of it (_band_mask_bits), the closest hit of
// every primary and extension ray on the band engine.
// Bound on the card: the f32 pipe — 41 flops per (ray, triangle) pair —
// over the pairs the culling leaves, plus the vote: each lane's slab test
// of each word's box and of the 32 clusters of the words its warp passes.
// The design (see the head of the file):
//  1. the block's bands vote their words into shared memory
//     (vote_band_words), equal bit for bit to band_mask_words';
//  2. the block walks the union of its bands' words in id order, one
//     64-triangle cluster a tile, staged once per block from the packed
//     table, the next tile's copy in flight while this one is swept;
//  3. a ray goes by a tile only if its own band flags the cluster and its
//     own grown box test admits it (slab_reach: entered no later than its
//     best t so far, widened by kSkipMargin), triangles across the warp's
//     threads, kTris a thread, the rays one at a time (ray_sweep.cuh): one
//     vote a ray and pass, a branch-free choice inside, ties to the lower
//     id.  The skip is conservative, so it moves no result.
// ``tmax`` (null: FLT_MAX) bounds the vote; a lane with a negative tmax is
// dead: it flags nothing, is swept by nothing and misses.
template <int kLanes>
__global__ void __launch_bounds__(kLanes)
band_closest_hit_kernel(const float4* __restrict__ packed, int num_tris,
                        const float* __restrict__ bounds,
                        const float* __restrict__ word_bounds, int n_clusters,
                        const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                        const float* __restrict__ tmax, const float* __restrict__ feats,
                        int n, int g, int* __restrict__ prim_out,
                        float* __restrict__ dist_out) {
  // the block's bands' words [kLanes / band_lanes][n_words], then their union
  extern __shared__ unsigned band_smem[];
  __shared__ float4 s[2][kCluster * kPackVec];
  __shared__ float4 recs[kLanes / kWarp][kWarp * kRecVec];
  const int n_words = (n_clusters + 31) >> 5;
  const int band_lanes = kRow / g;
  unsigned* uni = band_smem + (kLanes / band_lanes) * n_words;
  for (int i = threadIdx.x; i < (kLanes / band_lanes + 1) * n_words; i += kLanes) {
    band_smem[i] = 0u;
  }
  unsigned* own = band_smem + (threadIdx.x / band_lanes) * n_words;
  const int ray = blockIdx.x * kLanes + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float4* rec = recs[threadIdx.x / kWarp];
  const SlabRay sr = slab_ray(ray_o, ray_d, tmax, ray, n);
  const bool live = ray < n && sr.tm >= 0.f;  // not past the end, not dead
  {
    float f[10];
    load_feats(f, feats, ray, ray < n);
    // a record's result: best t so far, and its triangle's id as bits
    write_record(rec + lane * kRecVec, f, kFltMax, __int_as_float(-1));
  }
  __syncthreads();  // the words are zero
  const float slack =
      vote_band_words(own, uni, bounds, word_bounds, n_clusters, sr, live, band_lanes);
  __syncthreads();

  auto union_word = [&](int w) { return uni[w]; };
  TileWalk<kCluster> walk{n_words, kCluster, num_tris};
  bool more = walk.next(union_word);
  if (more) stage_packed(s[0], packed, walk.base, walk.count(), threadIdx.x, kLanes);
  cp_async_commit();
  for (int buf = 0; more; buf ^= 1) {
    const int base = walk.base, cnt = walk.count(), c = walk.c;
    const bool mine = live && ((own[c >> 5] >> (c & 31)) & 1u);  // my band flags c
    cp_async_wait<0>();  // this thread's part of the tile has landed
    // everyone's part has, and the other buffer's sweep is over
    __syncthreads();
    more = walk.next(union_word);
    if (more) stage_packed(s[buf ^ 1], packed, walk.base, walk.count(), threadIdx.x, kLanes);
    cp_async_commit();
    if (!__any_sync(kFull, mine)) continue;
    // the rays that can still gain from this tile: only a nearer t counts
    const unsigned rays = __ballot_sync(
        kFull, mine && slab_reach(sr, bounds + (size_t)c * 6, slack,
                                  rec[lane * kRecVec + 2].z * kSkipMargin));
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

// Replaces _band_occl_kernel (radish_pt_tpu/accel/pallas_kernels.py) and
// the band-mask prepass in front of it, the any-hit test of every NEE
// shadow segment on the band engine.
// Bound on the card: the f32 pipe — 43 flops per (segment, triangle) pair —
// over the pairs the culling leaves, plus the vote.  The design is the
// closest hit's with the segment's range as the fixed reach:
//  1. the block's bands vote their words into shared memory with each
//     segment's range as its tmax, equal bit for bit to
//     band_mask_words(cluster_bounds, segment_rays(x, y), g); every real
//     lane votes, one with a negative range too, as the prepass has it;
//  2. the block walks the union of its bands' words in id order, one
//     64-triangle cluster a tile, staged from the packed table through
//     cp.async, the next tile's copy in flight;
//  3. a segment goes by a tile only if its own band flags the cluster and
//     its own grown box test admits it within its range (slab_reach at
//     tm·kSkipMargin); triangles across the warp's threads, the segments one
//     at a time (sweep_any_tile), one __any_sync settling a segment.
// A segment with a negative range (zero-length: a masked lane) can be
// blocked by no triangle: it is settled from the start.  Settled segments
// leave the walk's ballots; the block leaves its walk through
// __syncthreads_and once every segment is settled.
template <int kLanes>
__global__ void __launch_bounds__(kLanes)
band_occlusion_kernel(const float4* __restrict__ packed, int num_tris,
                      const float* __restrict__ bounds,
                      const float* __restrict__ word_bounds, int n_clusters,
                      const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                      const float* __restrict__ tm_in, const float* __restrict__ feats,
                      int n, int g, int* __restrict__ occ_out) {
  extern __shared__ unsigned band_smem[];
  __shared__ float4 s[2][kCluster * kPackVec];
  __shared__ float4 recs[kLanes / kWarp][kWarp * kRecVec];
  const int n_words = (n_clusters + 31) >> 5;
  const int band_lanes = kRow / g;
  unsigned* uni = band_smem + (kLanes / band_lanes) * n_words;
  for (int i = threadIdx.x; i < (kLanes / band_lanes + 1) * n_words; i += kLanes) {
    band_smem[i] = 0u;
  }
  unsigned* own = band_smem + (threadIdx.x / band_lanes) * n_words;
  const int ray = blockIdx.x * kLanes + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float4* rec = recs[threadIdx.x / kWarp];
  const SlabRay sr = slab_ray(ray_o, ray_d, tm_in, ray, n);
  {
    float f[10];
    load_feats(f, feats, ray, ray < n);
    // a record's third word: the segment's range
    write_record(rec + lane * kRecVec, f, sr.tm, 0.f);
  }
  // the warp's segments still to settle, and those found blocked, a bit a lane
  unsigned open = __ballot_sync(kFull, ray < n && sr.tm >= 0.f);
  unsigned blocked_rays = 0;
  __syncthreads();  // the words are zero
  const float slack =
      vote_band_words(own, uni, bounds, word_bounds, n_clusters, sr, ray < n, band_lanes);
  __syncthreads();

  auto union_word = [&](int w) { return uni[w]; };
  TileWalk<kCluster> walk{n_words, kCluster, num_tris};
  bool more = walk.next(union_word);
  if (more) stage_packed(s[0], packed, walk.base, walk.count(), threadIdx.x, kLanes);
  cp_async_commit();
  for (int buf = 0; more; buf ^= 1) {
    const int cnt = walk.count(), c = walk.c;
    const bool mine = (open >> lane) & (own[c >> 5] >> (c & 31)) & 1u;  // my band flags c
    cp_async_wait<0>();
    // the tile's barrier, and whether every segment of the block is settled
    if (__syncthreads_and(open == 0)) break;
    more = walk.next(union_word);
    if (more) stage_packed(s[buf ^ 1], packed, walk.base, walk.count(), threadIdx.x, kLanes);
    cp_async_commit();
    if (!__any_sync(kFull, mine)) continue;
    // the open segments that reach this tile's cluster
    const unsigned rays = __ballot_sync(
        kFull, mine && slab_reach(sr, bounds + (size_t)c * 6, slack, sr.tm * kSkipMargin));
    if (rays == 0) continue;
    const unsigned hit = sweep_any_tile<kTris>(rec, s[buf], cnt, rays);
    open &= ~hit;
    blocked_rays |= hit;
  }
  cp_async_wait<0>();
  if (ray < n) occ_out[ray] = (blocked_rays >> lane) & 1u;
}

// Dynamic shared memory of either kernel: the block's bands' words, then
// their union.
template <int kLanes>
size_t words_smem(int n_clusters, int g) {
  return (size_t)(kLanes / (kRow / g) + 1) * ((n_clusters + 31) >> 5) * sizeof(unsigned);
}

// Raise a kernel's dynamic shared memory limit to ``smem`` only when it
// grows: cudaFuncSetAttribute then runs once per shape in a process, on the
// first launch, outside any CUDA graph capture (a capture follows an eager
// warm-up block of the same shapes), and not on every launch.  The limit
// is kept per process: the port drives one card per process.
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t smem, size_t& set_to) {
  if (smem <= set_to) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set_to = smem;
  return err;
}

template <int kLanes>
int launch_closest_hit(const float* packed, int num_tris, const float* bounds,
                       const float* word_bounds, int n_clusters, const float* ray_o,
                       const float* ray_d, const float* tmax, const float* feats, int n, int g,
                       int* prim_out, float* dist_out, cudaStream_t stream) {
  const size_t smem = words_smem<kLanes>(n_clusters, g);
  static size_t smem_set = 48 * 1024;  // the limit without the attribute
  const cudaError_t err = ensure_smem(band_closest_hit_kernel<kLanes>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kLanes - 1) / kLanes;
  band_closest_hit_kernel<kLanes><<<blocks, kLanes, smem, stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, bounds, word_bounds, n_clusters,
      ray_o, ray_d, tmax, feats, n, g, prim_out, dist_out);
  return (int)cudaGetLastError();
}

template <int kLanes>
int launch_occlusion(const float* packed, int num_tris, const float* bounds,
                     const float* word_bounds, int n_clusters, const float* ray_o,
                     const float* ray_d, const float* tm, const float* feats, int n, int g,
                     int* occ_out, cudaStream_t stream) {
  const size_t smem = words_smem<kLanes>(n_clusters, g);
  static size_t smem_set = 48 * 1024;  // the limit without the attribute
  const cudaError_t err = ensure_smem(band_occlusion_kernel<kLanes>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kLanes - 1) / kLanes;
  band_occlusion_kernel<kLanes><<<blocks, kLanes, smem, stream>>>(
      reinterpret_cast<const float4*>(packed), num_tris, bounds, word_bounds, n_clusters,
      ray_o, ray_d, tm, feats, n, g, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int band_closest_hit(const float* packed, int num_tris, const float* bounds,
                     const float* word_bounds, int n_clusters, const float* ray_o,
                     const float* ray_d, const float* tmax, const float* feats, int n, int g,
                     int* prim_out, float* dist_out, void* stream) {
  // a block holds whole bands
  auto launch = kRow / g > kBlockLanes ? &launch_closest_hit<kRow>
                                       : &launch_closest_hit<kBlockLanes>;
  return launch(packed, num_tris, bounds, word_bounds, n_clusters, ray_o, ray_d, tmax, feats,
                n, g, prim_out, dist_out, (cudaStream_t)stream);
}

int band_occlusion(const float* packed, int num_tris, const float* bounds,
                   const float* word_bounds, int n_clusters, const float* ray_o,
                   const float* ray_d, const float* tm, const float* feats, int n, int g,
                   int* occ_out, void* stream) {
  auto launch = kRow / g > kBlockLanes ? &launch_occlusion<kRow> : &launch_occlusion<kBlockLanes>;
  return launch(packed, num_tris, bounds, word_bounds, n_clusters, ray_o, ray_d, tm, feats, n,
                g, occ_out, (cudaStream_t)stream);
}

}  // extern "C"
