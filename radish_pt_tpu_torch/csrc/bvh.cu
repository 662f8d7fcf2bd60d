// MTBVH walks for Hopper (sm_90a): closest hit and any-hit as persistent,
// class-binned warps that refill finished lanes; the traversal heatmap as a
// warp-coherent walk of the least row its lanes are at; and the binning
// kernel that orders the rays for the first two.
//
// Replaces three XLA stages of the JAX package (not Pallas bodies):
// intersect_bvh, occlusion_bvh and intersect_bvh_heatmap
// (radish_pt_tpu/accel/traverse.py:408, :469, :570), which walk a
// wavefront in lockstep, one node a step for every lane, with a deferred
// leaf register and tail compaction to work round XLA's gathers; and the
// dead-lane sort of intersect_sorted (radish_pt_tpu/scene/device_scene.py:354),
// which bvh_bin_kernel replaces.  Every ray walks the reference renderer's
// own per-ray order (DevScene::intersect / testOcclusion /
// visualizedIntersect, scene.h:262-372): its direction class's threaded
// order with no stack, node + 1 when it descends into a box, the node's
// miss link when it does not, done at node B.
//
// Operands (accel/traverse.py::pack_bvh, accel/bvh.py):
// * nodes f32 [6B, 8]: per direction class and node, bmin.xyz, bmax.xyz,
//   the leaf row (int32 bits, -1 inside) and the miss link (int32 bits),
//   read as two 16-byte loads;
// * leaves f32 [R, L*9]: each leaf's L triangles (v0, e1, e2), zero padded
//   (det 0: never hit), read 9 floats a slot;
// * leaf_map i32 [R*L]: slot -> stored triangle id (closest hit only);
// * tmax f32 [N] (optional for the closest hit): a lane's range; a lane
//   whose range is not above 0 (or NaN) can meet no triangle, since a pair
//   counts only at 0 < t < range: it is settled by the binning kernel
//   (a miss, (-1, FLT_MAX, (0, 0)), or unblocked) and never walked;
// * ws i32 [6N + 16]: the binning kernel's queue of live lanes, six
//   regions of N, one a direction class, then its counters (kCount: live
//   lanes per class, each its region's cursor, and dead lanes; kHead: the
//   walk's queue head), zeroed with cudaMemsetAsync on the launch's
//   stream, so a CUDA-graph replay starts from zero.  Queue position q is
//   lane q - prefix_k of class k's region, prefix_k the live lanes of the
//   classes before k (about 15 MB at 800x800).
//
// Arithmetic, as the plain walk (accel/traverse.py::_walk) rounds it:
// 1/d is __frcp_rn (IEEE: +-0 -> +-inf; -use_fast_math stays out of the
// build); the slab test is _slab_core, every difference and product
// rounded on its own; the pair test is mt_pair.cuh's.  CUDA's fminf / fmaxf
// drop a NaN where torch.minimum / maximum keep it, so the NaN of 0 * inf
// (an origin on a slab plane, that direction component 0) is written out:
// the axis constrains nothing.  The plain version also clamps infinities
// to +-FLT_MAX; that changes no descent, which compares t_near only with a
// range above 0 (never with -FLT_MAX: such lanes are settled before their
// walk), so the kernel does not.  A lane descends only on t_near < its best
// (or its range) and takes a slot only on t < its best, both strict, slots
// in order: the first minimum in slot order wins, as the plain walk's dense
// leaf test picks it.
//
// Bound on the card: instruction issue.  A node visit is 31 f32
// operations (the six differences and products, six NaN tests, three
// minima and maxima, t_near, t_far, the verdict's three comparisons) and a
// leaf 16 x 55; the node table and the leaves fit the 50 MB L2
// (teapot_hires: 8.1 MB and 12.2 MB), so device memory sees little more
// than the rays.  The per-ray walk (the design until this one, and the
// heatmap's until the warp-coherent walk below) issued ~52 instructions a
// visit (ptxas' SASS: the two loads, their address, the NaN rule's tests,
// selects and constants, the loop), and a warp runs as long as its longest
// walk, its lanes test their leaves at different steps while the others
// wait, and a bounce wavefront in raster order mixes up to six direction
// classes, six threaded orders over six node tables, in one warp.  The
// closest hit and the any-hit walk answer each in turn:
// 1. bvh_bin_kernel: dead lanes written out at once; the live lanes queued
//    by direction class (warp-aggregated counts; a block reserves its run
//    in each class's region with one atomic and scatters; launch order
//    kept within a warp's and a block's share of a class), so a warp's
//    rays share one threaded order and, in raster order, their paths.
//    One launch a binning: it reads ray_d and tmax once and takes each
//    lane's class once.  Its bound is bytes (the directions and ranges
//    read, the queue written: 0.004 ms at 800x800), so what it costs is
//    the fixed cost of a launch, once a walk; the design until this one
//    was two launches (count, then scatter into one class-major array,
//    whose class offsets needed every block's counts first).
// 2. Persistent warps (Aila & Laine, "Understanding the Efficiency of Ray
//    Traversal on GPUs", HPG 2009): about as many blocks as the SMs hold;
//    a warp takes rays from the queue with one atomicAdd by lane 0, and
//    once BVH_REFILL of its lanes are free it writes their results to the
//    rays' own indices and refills them.  A lane's state is small (the
//    ray, 1/d, its order, node, range or best, a pending leaf): the walk is
//    stackless, and the node itself says whether the lane walks (below B),
//    so a step costs one compare beyond the visit, and the warp votes on
//    its walkers every BVH_VOTE_EVERY steps.
// 3. Leaves tested with the warp converged: a lane that descends into a
//    leaf parks there (it keeps the leaf row and its next node, node + 1);
//    the warp leaves its node loop when no lane walks (or enough lanes are
//    free to refill), then its parked lanes test their leaves together,
//    slots in order, strict t < c.  Each ray visits the nodes and tests the
//    leaves of the per-ray walk, in its order: bit for bit the same results.
// 4. While no lane of the warp holds a ray with a zero or non-finite
//    component, no product is 0 * inf: the warp takes the slab test without
//    the NaN rule's tests (warp-uniform, the same verdicts).
// What is left: a visit's ~40 instructions and its dependent load chain
// (the next row's address comes from this row); on bounce rays, whose
// lanes read different rows, each of a visit's two 16-byte loads touches a
// cache line a lane.
//
// Launched on the caller's stream; the C entry points return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_pair.cuh"

#ifndef BVH_HEAT_THREADS
#define BVH_HEAT_THREADS 64  // the heatmap: threads (rays) a block, whole warps
#endif
#ifndef BVH_HEAT_ROWS
#define BVH_HEAT_ROWS 1  // the heatmap: node rows a warp fetches a load (1, 2, 4, 8, 16)
#endif
#ifndef BVH_HEAT_LEAF
#define BVH_HEAT_LEAF 2  // the heatmap's leaves: 0 broadcast, 1 staged, 2 spread (see below)
#endif
#ifndef BVH_HEAT_SPREAD
#define BVH_HEAT_SPREAD 8  // BVH_HEAT_LEAF 2: spread below L x this / 16 rounds
#endif
#ifndef BVH_WARPS
#define BVH_WARPS 4  // the persistent walks: warps per block
#endif
#ifndef BVH_BLOCKS_PER_SM
#define BVH_BLOCKS_PER_SM 0  // 0: as many as the registers allow
#endif
#ifndef BVH_REFILL
#define BVH_REFILL 16  // free lanes at which a warp refills (1-32)
#endif
#ifndef BVH_VOTE_EVERY
#define BVH_VOTE_EVERY 4  // node steps between the warp's votes on its walkers
#endif
#ifndef BIN_THREADS
#define BIN_THREADS 256  // the binning kernel: threads (rays) per block
#endif

namespace {

constexpr int kThreads = 32 * BVH_WARPS;
constexpr int kHeatThreads = BVH_HEAT_THREADS;
constexpr int kHeatRows = BVH_HEAT_ROWS;
static_assert(kHeatThreads % 32 == 0 && kHeatThreads >= 32 && kHeatThreads <= 1024,
              "BVH_HEAT_THREADS: whole warps, at most 1024");
static_assert(kHeatRows >= 1 && kHeatRows <= 16 && (kHeatRows & (kHeatRows - 1)) == 0,
              "BVH_HEAT_ROWS: 1, 2, 4, 8 or 16");
static_assert(BVH_HEAT_LEAF >= 0 && BVH_HEAT_LEAF <= 2, "BVH_HEAT_LEAF: 0, 1 or 2");
constexpr int kRefill = BVH_REFILL;
constexpr int kMinBlocks = BVH_BLOCKS_PER_SM > 0 ? BVH_BLOCKS_PER_SM : 1;
static_assert(kRefill >= 1 && kRefill <= 32, "BVH_REFILL: 1 to 32 lanes");
static_assert(BVH_WARPS >= 1 && BVH_WARPS <= 32, "BVH_WARPS: 1 to 32");
constexpr unsigned kFull = 0xffffffffu;

// the binning kernel
constexpr int kBinThreads = BIN_THREADS;
constexpr int kBinWarps = kBinThreads / 32;
static_assert(kBinThreads % 32 == 0 && kBinThreads >= 32 && kBinThreads <= 1024,
              "BIN_THREADS: whole warps, at most 1024");
constexpr int kClasses = 6;
constexpr int kDead = 6;  // the bin of lanes settled up front
constexpr int kBins = 7;
// counters after the six regions (ws + 6N); accel/traverse.py::WS_COUNTERS
constexpr int kCounters = 16;
constexpr int kCount = 0;  // [kCount, kCount + 7): lanes per class (each region's cursor), dead
constexpr int kHead = 8;   // the walks' queue head
// what the binning kernel writes for a dead lane
enum DeadOut { kMissOut = 0, kUnblockedOut = 1, kNoOut = 2 };

using mt::kFltMax;
using mt::Ray;
using mt::load_ray;
using mt::mt_pair;

// get_dir_class(-d): the threaded order the ray walks
__device__ __forceinline__ int dir_class(float dx, float dy, float dz) {
  const float x = -dx, y = -dy, z = -dz;
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const int xc = x > 0.f ? 0 : 1, yc = y > 0.f ? 2 : 3, zc = z > 0.f ? 4 : 5;
  return ax > ay ? (ax > az ? xc : zc) : (ay > az ? yc : zc);
}

__device__ __forceinline__ int dir_class(const Ray& r) { return dir_class(r.dx, r.dy, r.dz); }

// one axis of _slab_core: (lo, hi), both "unconstrained" on a NaN
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o, float inv,
                                          float& lo, float& hi) {
  const float t1 = __fmul_rn(__fsub_rn(bmin, o), inv);
  const float t2 = __fmul_rn(__fsub_rn(bmax, o), inv);
  const bool nan = t1 != t1 || t2 != t2;  // no fast math: a NaN is unequal to itself
  lo = nan ? -kFltMax : fminf(t1, t2);
  hi = nan ? kFltMax : fmaxf(t1, t2);
}

struct Best {
  float t;
  int slot;
  float bx, by;
};

// slab_axis for a ray whose origin, direction and 1/d are finite: no
// product is 0 * inf, so no NaN to write out (the same lo and hi)
__device__ __forceinline__ void slab_axis_finite(float bmin, float bmax, float o, float inv,
                                                 float& lo, float& hi) {
  const float t1 = __fmul_rn(__fsub_rn(bmin, o), inv);
  const float t2 = __fmul_rn(__fsub_rn(bmax, o), inv);
  lo = fminf(t1, t2);
  hi = fmaxf(t1, t2);
}

// One node of a ray's threaded order: true where the ray descends into its
// box (hit, entered before c); the node's leaf row and miss link.  kNan:
// the slab test with the NaN rule (a ray with a zero or non-finite
// component), else without.
template <bool kNan>
__device__ __forceinline__ bool visit(const float4* __restrict__ order, int node,
                                      const Ray& r, float ix, float iy, float iz, float c,
                                      int& leaf, int& miss) {
  const float4 a = __ldg(order + 2 * node);      // bmin.xyz, bmax.x
  const float4 b = __ldg(order + 2 * node + 1);  // bmax.yz, leaf, miss
  float lx, hx, ly, hy, lz, hz;
  if (kNan) {
    slab_axis(a.x, a.w, r.ox, ix, lx, hx);
    slab_axis(a.y, b.x, r.oy, iy, ly, hy);
    slab_axis(a.z, b.y, r.oz, iz, lz, hz);
  } else {
    slab_axis_finite(a.x, a.w, r.ox, ix, lx, hx);
    slab_axis_finite(a.y, b.x, r.oy, iy, ly, hy);
    slab_axis_finite(a.z, b.y, r.oz, iz, lz, hz);
  }
  const float t_near = fmaxf(lx, fmaxf(ly, lz));
  const float t_far = fminf(hx, fminf(hy, hz));
  leaf = __float_as_int(b.z);
  miss = __float_as_int(b.w);
  return t_far >= 0.f && t_far >= t_near && t_near < c;
}

// One leaf's L slots in order against the ray.  Closest hit: a slot hit at
// t < c becomes the best (c = t).  Any-hit: true at the first such slot,
// which becomes best.slot.
template <bool kAny>
__device__ __forceinline__ bool test_leaf(const float* __restrict__ leaves, int L, int leaf,
                                          const Ray& r, float& c, Best& best) {
  const float* t9 = leaves + (size_t)leaf * L * 9;
  for (int j = 0; j < L; ++j, t9 += 9) {
    float t, u, v, inv_det;
    if (!mt_pair(t9, r, t, u, v, inv_det) || !(t < c)) continue;
    if (kAny) {
      best.slot = leaf * L + j;
      return true;
    }
    c = t;
    best.t = t;
    best.slot = leaf * L + j;
    best.bx = __fmul_rn(u, inv_det);
    best.by = __fmul_rn(v, inv_det);
  }
  return false;
}

// The walks of one persistent warp over the binning kernel's queue (six
// regions of n lanes, one a class).
// Closest hit (kAny false): prim, dist and bary of each ray at its index;
// any-hit: 1 where a slot is hit below the ray's range, else 0.  A lane's
// state is its node: below B it walks; kStop (or B, its walk done) it does
// not: free or done when it has no pending leaf, parked when it has one.
// A done lane's result is written when the warp next looks for free lanes.
constexpr int kStop = 0x7fffffff;

template <bool kAny>
__device__ __forceinline__ void persistent_walk(
    const float4* __restrict__ nodes, int size, const float* __restrict__ leaves, int L,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ tmax, const int* __restrict__ queue, int n, int* counters,
    const int* __restrict__ leaf_map, int* __restrict__ out_i, float* __restrict__ dist_out,
    float* __restrict__ bary_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the queue position of each class's first lane, then the live lanes
  // (in shared memory: the walk's registers stay as they were)
  __shared__ int prefix[kClasses + 1];
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < kClasses; ++k) {
      prefix[k] = sum;
      sum += counters[kCount + k];
    }
    prefix[kClasses] = sum;
  }
  __syncthreads();
  const int live = prefix[kClasses];
  int* head = counters + kHead;

  int ray = -1;  // the lane's ray (its index in the launch); -1: none
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ix = 0.f, iy = 0.f, iz = 0.f, c = 0.f;
  const float4* order = nodes;
  int node = kStop;  // below size: the lane walks
  int leaf = -1;     // the pending leaf row of a parked lane
  int resume = 0;    // a parked lane's next node
  int finite = 1;    // the lane's ray, 1/d included, is finite
  bool nan_rule = false;  // warp-uniform: some lane's ray may meet 0 * inf
  bool drained = false;   // the queue has no ray left for this warp
  Best best{kFltMax, -1, 0.f, 0.f};

  while (true) {
    // 1. the lanes done write their results; once enough lanes are free,
    // they take rays from the queue
    const bool free_lane = node >= size && leaf < 0;
    if (free_lane && ray >= 0) {
      if (kAny) {
        out_i[ray] = best.slot >= 0 ? 1 : 0;
      } else {
        out_i[ray] = best.slot >= 0 ? leaf_map[best.slot] : -1;
        dist_out[ray] = best.t;
        bary_out[2 * (size_t)ray] = best.bx;
        bary_out[2 * (size_t)ray + 1] = best.by;
      }
      ray = -1;
    }
    const unsigned free_lanes = __ballot_sync(kFull, free_lane);
    if (!drained && __popc(free_lanes) >= kRefill) {
      const int want = __popc(free_lanes);
      int base = 0;
      if (lane == 0) base = atomicAdd(head, want);
      base = __shfl_sync(kFull, base, 0);
      drained = base + want >= live;
      const int q = base + __popc(free_lanes & below);
      if (free_lane && q < live) {
        int cls = 0, start = 0;  // queue position q: lane q - start of class cls's region
#pragma unroll
        for (int k = 1; k < kClasses; ++k) {
          if (q >= prefix[k]) {
            cls = k;
            start = prefix[k];
          }
        }
        ray = __ldg(queue + (size_t)cls * n + (q - start));
        r = load_ray(ray_o, ray_d, ray, true);
        ix = __frcp_rn(r.dx);
        iy = __frcp_rn(r.dy);
        iz = __frcp_rn(r.dz);
        finite = isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) && isfinite(r.dx) &&
                 isfinite(r.dy) && isfinite(r.dz) && isfinite(ix) && isfinite(iy) &&
                 isfinite(iz);
        order = nodes + 2 * (size_t)cls * size;  // cls == dir_class(r)
        c = tmax != nullptr ? __ldg(tmax + ray) : kFltMax;
        node = 0;
        best = Best{kFltMax, -1, 0.f, 0.f};
      }
      nan_rule = __any_sync(kFull, ray >= 0 && !finite);
    }
    if (!__any_sync(kFull, ray >= 0)) return;  // drained, every result written

    // 2. the node loop: each walking lane visits one node a step, until
    // every lane is parked, done or free, or enough lanes are free; the
    // warp votes every BVH_VOTE_EVERY steps
    unsigned walkers = __ballot_sync(kFull, node < size), seen = walkers;
    while (walkers) {
#pragma unroll
      for (int k = 0; k < BVH_VOTE_EVERY; ++k) {
        if (node >= size) continue;
        int nleaf, miss;
        const bool desc =
            nan_rule ? visit<true>(order, node, r, ix, iy, iz, c, nleaf, miss)
                     : visit<false>(order, node, r, ix, iy, iz, c, nleaf, miss);
        if (!desc) {
          node = miss;
        } else if (nleaf < 0) {
          ++node;
        } else {  // park: tested with the warp's other parked lanes
          leaf = nleaf;
          resume = node + 1;
          node = kStop;
        }
      }
      walkers = __ballot_sync(kFull, node < size);
      if (walkers != seen) {  // a lane parked or finished
        seen = walkers;
        if (!drained && __popc(__ballot_sync(kFull, node >= size && leaf < 0)) >= kRefill)
          break;
      }
    }

    // 3. the parked lanes test their leaves together, slots in order, and
    // walk on past them
    __syncwarp();
    if (leaf >= 0) {
      node = test_leaf<kAny>(leaves, L, leaf, r, c, best) ? kStop : resume;
      leaf = -1;
    }
  }
}

// Blocks of the persistent walks: as many as the card holds at once
// (BVH_BLOCKS_PER_SM a SM, or what the registers allow), no more than the
// rays fill; the card's count is cached per walk on the first launch (a
// host query, made before any CUDA-graph capture of the frame).
template <typename Kernel>
int walk_blocks(Kernel kernel, int slot, int n) {
  static int resident[2] = {0, 0};
  if (resident[slot] == 0) {
    int dev = 0, sms = 0, per_sm = BVH_BLOCKS_PER_SM;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (per_sm <= 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    resident[slot] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const int fill = (n + kThreads - 1) / kThreads;
  return fill < resident[slot] ? fill : resident[slot];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh_closest_hit_kernel(const float4* __restrict__ nodes, int size,
                       const float* __restrict__ leaves, int L,
                       const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                       const float* __restrict__ tmax, const int* __restrict__ leaf_map,
                       int* __restrict__ prim_out, float* __restrict__ dist_out,
                       float* __restrict__ bary_out, const int* __restrict__ queue, int n,
                       int* counters) {
  persistent_walk<false>(nodes, size, leaves, L, ray_o, ray_d, tmax, queue, n, counters,
                         leaf_map, prim_out, dist_out, bary_out);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh_occlusion_kernel(const float4* __restrict__ nodes, int size,
                     const float* __restrict__ leaves, int L,
                     const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                     const float* __restrict__ tmax, int* __restrict__ occ_out,
                     const int* __restrict__ queue, int n, int* counters) {
  persistent_walk<true>(nodes, size, leaves, L, ray_o, ray_d, tmax, queue, n, counters,
                        nullptr, occ_out, nullptr, nullptr);
}

// The traversal heatmap: a warp-coherent walk.  The heatmap's only caller
// (render/renderer.py::_bvh_heatmap) gives pinhole primaries in raster
// order, so a warp's 32 rays are 32 pixels of one row.  Every miss link of
// the threaded tables is larger than its node (each class of teapot's and
// of the test soups' tables: tests/test_torch_heatmap_sched.py), so a ray
// visits its class's rows in increasing order, and a warp can walk "the
// least row any of its lanes is at":
// * a lane's key is its row, class x B + node (kNoKey once done);
// * each step the warp takes m = __reduce_min_sync(key) and reads row m
//   once for every lane (a warp-uniform address: one load, or a shuffle of
//   rows fetched before, BVH_HEAT_ROWS); the lanes whose key is m take the
//   slab test, the others idle on it;
// * a lane that descends counts a step and moves to node + 1, any other
//   lane at m to the miss link; a leaf that some lane descended into (a
//   vote) is tested for those lanes at once (BVH_HEAT_LEAF).
// Each lane visits exactly its own sequence, with the per-ray walk's
// arithmetic, so its count is the plain walk's; for any table, since the
// least key always moves on, the order only costs steps: a warp takes as
// many as the rows its lanes visit between them (the plain model:
// accel/traverse.py::heatmap_warp_model).  While no lane holds a ray with
// a zero or non-finite component, the warp takes the slab test without
// the NaN rule's tests (slab_axis_finite: the same verdicts).  Every
// branch of a step is warp-uniform, so no lane's walk waits on another
// lane's divergent path, and the loads of a step are one row (32 B) and,
// at a leaf, one leaf (576 B) for the warp.
// The leaves (BVH_HEAT_LEAF): a lane's best only falls to the least t < c
// of a hit slot, and that least value is the same in any order, so
// 2: the warp spreads the (descending lane, slot) pairs over its lanes, L
//    lanes a ray (32 / L rays a round; L a power of 2 up to 32), takes each
//    ray's least t with a butterfly of shuffles and hands it back:
//    ceil(k / (32 / L)) rounds of one pair test a lane for k descending
//    lanes, where that is fewer than L x BVH_HEAT_SPREAD / 16 (a round
//    issues ~1.4 times the instructions of a slot in order; tune heat:
//    half of L was best), else as 1;
// 1: the leaf's L x 9 floats staged in shared memory by the warp, each
//    descending lane testing the L slots in order from there;
// 0: each descending lane tests the L slots in order at the leaf's
//    warp-uniform address (broadcast loads).
// On an H100 (800x800 primaries, PERF.md) teapot runs near 40% of the
// instruction-rate bound, teapot_hires near 25%: its node rows come mostly
// from L2, and its walk without the leaf tests takes nearly as long.
// Slower there, and left out: loading row m + 1 ahead (72 registers), an
// L1 prefetch of the miss link's row, persistent warps taking 32 rays at a
// time, and one-warp blocks.
constexpr int kNoKey = 0x7fffffff;  // the key of a lane done or without a ray

// Rows of the node table fetched by the warp: lane j holds float4 j of rows
// [first, first + BVH_HEAT_ROWS) (first warp-uniform).
struct HeatRows {
  float4 held;
  int first;
};

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

// Row m (warp-uniform) for every lane: bmin.xyz, bmax.x in a; bmax.yz,
// leaf, miss in b.  BVH_HEAT_ROWS 1: two loads at the row's address; else
// the rows from m on fetched in one coalesced load whenever m is not among
// the held rows, row m read with shuffles.
__device__ __forceinline__ void heat_row(const float4* __restrict__ nodes, int rows, int m,
                                         HeatRows& held, float4& a, float4& b) {
  if (kHeatRows == 1) {
    a = __ldg(nodes + 2 * (size_t)m);
    b = __ldg(nodes + 2 * (size_t)m + 1);
    return;
  }
  if (m < held.first || m >= held.first + kHeatRows) {
    const int lane = threadIdx.x & 31;
    held.first = m;
    if (lane < 2 * kHeatRows && m + (lane >> 1) < rows)
      held.held = __ldg(nodes + 2 * (size_t)m + lane);
  }
  const int j = 2 * (m - held.first);
  a = shfl4(held.held, j);
  b = shfl4(held.held, j + 1);
}

// A leaf's L slots in order against a descending lane's ray: c falls to a
// hit slot's t below it (strict), as in the per-ray walk.
__device__ __forceinline__ void heat_leaf_in_order(const float* t9, int L, const Ray& r,
                                                   bool desc, float& c) {
  if (!desc) return;
  for (int j = 0; j < L; ++j, t9 += 9) {
    float t, u, v, inv_det;
    if (mt_pair(t9, r, t, u, v, inv_det) && t < c) c = t;
  }
}

// The (descending lane, slot) pairs of a leaf spread over the warp, L lanes
// a ray: lane g * L + s tests slot s for the g-th ray of the round; the L
// lanes of a ray take the least hit t below its c, which the ray's own lane
// reads back.  L a power of 2 up to 32.
__device__ __forceinline__ void heat_leaf_spread(const float* __restrict__ leaf, int L,
                                                 const Ray& r, bool desc, float& c) {
  const int lane = threadIdx.x & 31;
  const unsigned want = __ballot_sync(kFull, desc);
  const int shift = __ffs(L) - 1;        // L = 1 << shift
  const int per_round = 32 >> shift;     // rays a round
  const int group = lane >> shift;       // the ray of the round this lane serves
  const float* t9 = leaf + 9 * (lane & (L - 1));
  const int rank = __popc(want & ((1u << lane) - 1u));  // a descending lane's place
  const int my_round = rank >> (5 - shift);
  const int my_group = (rank & (per_round - 1)) << shift;  // the lane that holds its least t
  float tri[9];  // this lane's slot, the same every round
#pragma unroll
  for (int k = 0; k < 9; ++k) tri[k] = __ldg(t9 + k);
  unsigned left = want;
  for (int round = 0; left; ++round) {
    unsigned mine = left;  // the group's ray: the group-th of the rays left
    for (int g = 0; g < group; ++g) mine &= mine - 1u;
    const int src = __ffs(mine) - 1;  // -1: no ray for this group
    for (int g = 0; g < per_round; ++g) left &= left - 1u;
    const int s = src & 31;
    const Ray q{__shfl_sync(kFull, r.ox, s), __shfl_sync(kFull, r.oy, s),
                __shfl_sync(kFull, r.oz, s), __shfl_sync(kFull, r.dx, s),
                __shfl_sync(kFull, r.dy, s), __shfl_sync(kFull, r.dz, s)};
    const float cq = __shfl_sync(kFull, c, s);
    float best = kFltMax;
    float t, u, v, inv_det;
    if (src >= 0 && mt_pair(tri, q, t, u, v, inv_det) && t < cq) best = t;
    for (int off = L >> 1; off > 0; off >>= 1)
      best = fminf(best, __shfl_xor_sync(kFull, best, off));
    const float got = __shfl_sync(kFull, best, my_group);
    if (desc && my_round == round && got < c) c = got;
  }
}

// One ray's heatmap count, its lane walking with the warp from key (its
// class's first row, or kNoKey).  kNan: the slab test with the NaN rule.
template <bool kNan>
__device__ __forceinline__ int heat_walk(const float4* __restrict__ nodes, int size,
                                         const float* __restrict__ leaves, int L,
                                         float* stage, const Ray& r, float ix, float iy,
                                         float iz, int base, int key) {
  const int rows = kClasses * size;
  HeatRows held{make_float4(0.f, 0.f, 0.f, 0.f), -kHeatRows};
  const int end = base + size;  // past the lane's class's rows
  float c = kFltMax;  // a box must be entered before c to be descended into
  int steps = 0;
  int m = __reduce_min_sync(kFull, key);
  while (m != kNoKey) {
    const bool here = key == m;
    float4 a, b;
    heat_row(nodes, rows, m, held, a, b);
    float lx, hx, ly, hy, lz, hz;
    if (kNan) {
      slab_axis(a.x, a.w, r.ox, ix, lx, hx);
      slab_axis(a.y, b.x, r.oy, iy, ly, hy);
      slab_axis(a.z, b.y, r.oz, iz, lz, hz);
    } else {
      slab_axis_finite(a.x, a.w, r.ox, ix, lx, hx);
      slab_axis_finite(a.y, b.x, r.oy, iy, ly, hy);
      slab_axis_finite(a.z, b.y, r.oz, iz, lz, hz);
    }
    const float t_near = fmaxf(lx, fmaxf(ly, lz));
    const float t_far = fminf(hx, fminf(hy, hz));
    const bool desc = here && t_far >= 0.f && t_far >= t_near && t_near < c;
    steps += desc;
    const bool any_desc = __any_sync(kFull, desc);
    const int leaf = __float_as_int(b.z);
    if (leaf >= 0 && any_desc) {  // warp-uniform
      const float* t9 = leaves + (size_t)leaf * L * 9;
      if (BVH_HEAT_LEAF == 2 && L > 0 && L <= 32 && (L & (L - 1)) == 0 &&
          16 * ((__popc(__ballot_sync(kFull, desc)) * L + 31) / 32) < L * BVH_HEAT_SPREAD) {
        heat_leaf_spread(t9, L, r, desc, c);
      } else if (BVH_HEAT_LEAF >= 1) {  // 1, and 2 with many descending lanes
        __syncwarp();  // the warp's reads of the last leaf staged are done
        for (int k = threadIdx.x & 31; k < 9 * L; k += 32) stage[k] = __ldg(t9 + k);
        __syncwarp();
        heat_leaf_in_order(stage, L, r, desc, c);
      } else {
        heat_leaf_in_order(t9, L, r, desc, c);
      }
    }
    if (here) {  // node + 1 or the miss link, as a key: done past the class's rows
      const int next = desc ? m + 1 : base + __float_as_int(b.w);
      key = next < end ? next : kNoKey;
    }
    m = __reduce_min_sync(kFull, key);
  }
  return steps;
}

__global__ void __launch_bounds__(kHeatThreads)
bvh_heatmap_kernel(const float4* __restrict__ nodes, int size,
                   const float* __restrict__ leaves, int L,
                   const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n,
                   int* __restrict__ steps_out) {
  extern __shared__ float heat_stage[];  // BVH_HEAT_LEAF 1 and 2: L * 9 floats a warp
  const int ray = blockIdx.x * kHeatThreads + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  const float ix = __frcp_rn(r.dx), iy = __frcp_rn(r.dy), iz = __frcp_rn(r.dz);
  const bool finite = isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) && isfinite(r.dx) &&
                      isfinite(r.dy) && isfinite(r.dz) && isfinite(ix) && isfinite(iy) &&
                      isfinite(iz);
  const int base = dir_class(r) * size;
  const int key = live && size > 0 ? base : kNoKey;
  float* stage = heat_stage + (size_t)(threadIdx.x >> 5) * 9 * L;
  // warp-uniform: the finite path while no lane's ray can meet 0 * inf
  const int steps =
      __all_sync(kFull, finite || !live)
          ? heat_walk<false>(nodes, size, leaves, L, stage, r, ix, iy, iz, base, key)
          : heat_walk<true>(nodes, size, leaves, L, stage, r, ix, iy, iz, base, key);
  if (live) steps_out[ray] = steps;
}

// The binning of a wavefront in one pass.  Each lane's bin: its direction
// class, or kDead where its range is not above 0.  A warp aggregates its
// lanes of one bin (__match_any_sync), a block its warps' in shared
// memory, and one thread a bin reserves the block's run in the bin with
// one atomic on the bin's cursor (after the launch the cursors are the
// counts); then each live lane is written into its class's region at the
// block's run, its warp's place in the run and its rank in the warp, and
// each dead lane's result is written out (``dead_out``).
__global__ void __launch_bounds__(kBinThreads)
bvh_bin_kernel(const float* __restrict__ ray_d, const float* __restrict__ tmax, int n,
               int dead_out, int* __restrict__ out_i, float* __restrict__ out_f,
               float* __restrict__ out_b, int* __restrict__ queue, int* counters) {
  __shared__ int counts[kBinWarps][kBins];
  __shared__ int run[kBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  int bin = kBins;  // beyond the wavefront: no bin
  if (i < n) {
    const float range = tmax != nullptr ? tmax[i] : kFltMax;
    bin = range > 0.f ? dir_class(ray_d[3 * (size_t)i], ray_d[3 * (size_t)i + 1],
                                  ray_d[3 * (size_t)i + 2])
                      : kDead;
  }
  for (int k = threadIdx.x; k < kBinWarps * kBins; k += kBinThreads) (&counts[0][0])[k] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(kFull, bin);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (bin < kBins && rank == 0) counts[warp][bin] = __popc(peers);
  __syncthreads();
  if (threadIdx.x < kBins) {
    const int k = threadIdx.x;
    int total = 0;
    for (int w = 0; w < kBinWarps; ++w) {  // each warp's first position in the block's run
      const int m = counts[w][k];
      counts[w][k] = total;
      total += m;
    }
    run[k] = total ? atomicAdd(counters + kCount + k, total) : 0;
  }
  __syncthreads();
  if (bin < kClasses) {
    queue[(size_t)bin * n + run[bin] + counts[warp][bin] + rank] = i;
  } else if (bin == kDead && dead_out == kMissOut) {
    out_i[i] = -1;
    out_f[i] = kFltMax;
    out_b[2 * (size_t)i] = 0.f;
    out_b[2 * (size_t)i + 1] = 0.f;
  } else if (bin == kDead && dead_out == kUnblockedOut) {
    out_i[i] = 0;
  }
}

}  // namespace

extern "C" {

int bvh_bin(const float* ray_d, const float* tmax, int n, int dead_out, int* out_i,
            float* out_f, float* out_b, int* ws, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int* counters = ws + (size_t)kClasses * n;
  const cudaError_t err = cudaMemsetAsync(counters, 0, kCounters * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + kBinThreads - 1) / kBinThreads;
    bvh_bin_kernel<<<blocks, kBinThreads, 0, s>>>(ray_d, tmax, n, dead_out, out_i, out_f,
                                                  out_b, ws, counters);
  }
  return (int)cudaGetLastError();
}

int bvh_closest_hit(const float* nodes, int size, const float* leaves, int L,
                    const float* ray_o, const float* ray_d, int n, const float* tmax,
                    const int* leaf_map, int* prim_out, float* dist_out, float* bary_out,
                    int* ws, void* stream) {
  const int blocks = walk_blocks(bvh_closest_hit_kernel, 0, n);
  bvh_closest_hit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, tmax, leaf_map,
      prim_out, dist_out, bary_out, ws, n, ws + (size_t)kClasses * n);
  return (int)cudaGetLastError();
}

int bvh_occlusion(const float* nodes, int size, const float* leaves, int L,
                  const float* ray_o, const float* ray_d, int n, const float* tmax,
                  int* occ_out, int* ws, void* stream) {
  const int blocks = walk_blocks(bvh_occlusion_kernel, 1, n);
  bvh_occlusion_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, tmax, occ_out,
      ws, n, ws + (size_t)kClasses * n);
  return (int)cudaGetLastError();
}

int bvh_heatmap(const float* nodes, int size, const float* leaves, int L,
                const float* ray_o, const float* ray_d, int n, int* steps_out,
                void* stream) {
  const int blocks = (n + kHeatThreads - 1) / kHeatThreads;
  const size_t stage =
      BVH_HEAT_LEAF >= 1 ? (size_t)(kHeatThreads / 32) * 9 * L * sizeof(float) : 0;
  bvh_heatmap_kernel<<<blocks, kHeatThreads, stage, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), size, leaves, L, ray_o, ray_d, n, steps_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
