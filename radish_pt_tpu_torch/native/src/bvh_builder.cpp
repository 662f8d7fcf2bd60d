// SAH BVH builder + 6-way MTBVH threading + leaf-major packing, in C++.
//
// The native twin of radish_pt_tpu_torch/accel/bvh.py::build_bvh_numpy, equal
// to it array for array: 16-bucket SAH binning, leaves of up to leaf_size
// triangles, near-to-far threaded DFS orders per axis-sign class (Hachisuka's
// MTBVH; the reference builds this on the host, bvh.cpp:12-183).
//
// Where numpy's arithmetic decides the tree, this file does the same
// arithmetic: the bucket areas in f32, the SAH cost in f64 (numpy's
// frac = count_prefix / n_sub is a float64 division, so the cost and its
// argmin run in float64), the argmin taking the first minimum (or the first
// NaN) over the 15 split buckets with invalid ones at +inf.  Build with
// -ffp-contract=off: a fused multiply-add rounds once where numpy rounds
// twice.
//
// C ABI for ctypes; the caller allocates worst-case buffers (nodes <= 2T-1,
// leaves <= T) and receives the actual counts.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBuckets = 16;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// numpy's area(): 2 (dx dy + dy dz + dz dx) of the clamped extents, in f32
inline float area(const Vec3 &mn, const Vec3 &mx) {
  float dx = std::max(mx.x - mn.x, 0.f);
  float dy = std::max(mx.y - mn.y, 0.f);
  float dz = std::max(mx.z - mn.z, 0.f);
  return 2.f * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  int num_prims;
  int leaf_size;
  const float *verts;  // [3T, 3]

  std::vector<Vec3> prim_min, prim_max, prim_center;
  std::vector<int32_t> order;

  // tree arrays (pass 1)
  std::vector<Vec3> n_bmin, n_bmax;
  std::vector<int32_t> n_left, n_right, n_leafrow;
  std::vector<std::vector<int32_t>> leaf_prims;
  int depth = 0;

  void prim_setup() {
    prim_min.resize(num_prims);
    prim_max.resize(num_prims);
    prim_center.resize(num_prims);
    order.resize(num_prims);
    for (int i = 0; i < num_prims; ++i) {
      const float *p = verts + (size_t)i * 9;
      Vec3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
      prim_min[i] = vmin(a, vmin(b, c));
      prim_max[i] = vmax(a, vmax(b, c));
      prim_center[i] = {(prim_min[i].x + prim_max[i].x) * 0.5f,
                        (prim_min[i].y + prim_max[i].y) * 0.5f,
                        (prim_min[i].z + prim_max[i].z) * 0.5f};
      order[i] = i;
    }
  }

  struct Item {
    int start, end, parent;
    bool is_right;
  };

  // the bucket numpy's astype(int32) of t * 16 gives, clipped to [0, 15]
  int bucket_of(int id, int axis, float cmin, float extent) const {
    float t = (prim_center[id][axis] - cmin) / extent;
    int b = (int)(t * kNumBuckets);
    return std::min(std::max(b, 0), kNumBuckets - 1);
  }

  // the split bucket of a node's prims [start, end]: numpy's argmin of
  // where(valid, la (1 - frac) + ra frac, inf) in float64
  int split_bucket(int start, int end, int axis, float cmin, float extent) const {
    int64_t counts[kNumBuckets] = {0};
    Vec3 bmn[kNumBuckets], bmx[kNumBuckets];
    for (int b = 0; b < kNumBuckets; ++b) {
      bmn[b] = {kInf, kInf, kInf};
      bmx[b] = {-kInf, -kInf, -kInf};
    }
    for (int i = start; i <= end; ++i) {
      int id = order[i];
      int b = bucket_of(id, axis, cmin, extent);
      counts[b] += 1;
      bmn[b] = vmin(bmn[b], prim_min[id]);
      bmx[b] = vmax(bmx[b], prim_max[id]);
    }
    Vec3 lmn[kNumBuckets], lmx[kNumBuckets], rmn[kNumBuckets], rmx[kNumBuckets];
    int64_t prefix[kNumBuckets];
    lmn[0] = bmn[0];
    lmx[0] = bmx[0];
    prefix[0] = counts[0];
    for (int b = 1; b < kNumBuckets; ++b) {
      lmn[b] = vmin(lmn[b - 1], bmn[b]);
      lmx[b] = vmax(lmx[b - 1], bmx[b]);
      prefix[b] = prefix[b - 1] + counts[b];
    }
    rmn[kNumBuckets - 1] = bmn[kNumBuckets - 1];
    rmx[kNumBuckets - 1] = bmx[kNumBuckets - 1];
    for (int b = kNumBuckets - 2; b >= 0; --b) {
      rmn[b] = vmin(rmn[b + 1], bmn[b]);
      rmx[b] = vmax(rmx[b + 1], bmx[b]);
    }
    const int64_t n_sub = end - start + 1;
    double best = std::numeric_limits<double>::infinity();
    int div_bucket = 0;
    for (int b = 0; b < kNumBuckets - 1; ++b) {
      double sah = std::numeric_limits<double>::infinity();
      if (prefix[b] > 0 && prefix[b] < n_sub) {
        double frac = (double)prefix[b] / (double)n_sub;
        double la = area(lmn[b], lmx[b]);
        double ra = area(rmn[b + 1], rmx[b + 1]);
        sah = la * (1.0 - frac) + ra * frac;
      }
      if (std::isnan(sah)) return b;  // numpy's argmin stops at a NaN
      if (sah < best) {
        best = sah;
        div_bucket = b;
      }
    }
    return div_bucket;
  }

  void build_tree() {
    std::vector<Item> stack;
    stack.push_back({0, num_prims - 1, -1, false});
    std::vector<int32_t> lefts, rights;
    while (!stack.empty()) {
      depth = std::max(depth, (int)stack.size());
      Item it = stack.back();
      stack.pop_back();
      int my = (int)n_bmin.size();
      if (it.parent >= 0) {
        (it.is_right ? n_right : n_left)[it.parent] = my;
      }
      int n_sub = it.end - it.start + 1;
      Vec3 bmin{kInf, kInf, kInf}, bmax{-kInf, -kInf, -kInf};
      Vec3 cmin{kInf, kInf, kInf}, cmax{-kInf, -kInf, -kInf};
      for (int i = it.start; i <= it.end; ++i) {
        int id = order[i];
        bmin = vmin(bmin, prim_min[id]);
        bmax = vmax(bmax, prim_max[id]);
        cmin = vmin(cmin, prim_center[id]);
        cmax = vmax(cmax, prim_center[id]);
      }
      n_bmin.push_back(bmin);
      n_bmax.push_back(bmax);
      n_left.push_back(-1);
      n_right.push_back(-1);

      if (n_sub <= leaf_size) {
        n_leafrow.push_back((int)leaf_prims.size());
        leaf_prims.emplace_back(order.begin() + it.start, order.begin() + it.end + 1);
        continue;
      }
      n_leafrow.push_back(-1);

      // numpy's argmax: the first axis of the largest centroid extent
      Vec3 ext{cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
      int axis = 0;
      if (ext.y > ext.x) axis = 1;
      if (ext.z > ext[axis]) axis = 2;
      float extent = ext[axis];

      int mid;
      if (extent <= 0.f) {
        mid = it.start + n_sub / 2 - 1;  // coincident centroids: halve
      } else {
        int div = split_bucket(it.start, it.end, axis, cmin[axis], extent);
        // stable partition (numpy's boolean-mask concatenation)
        lefts.clear();
        rights.clear();
        for (int i = it.start; i <= it.end; ++i) {
          int id = order[i];
          (bucket_of(id, axis, cmin[axis], extent) <= div ? lefts : rights).push_back(id);
        }
        int n_l = (int)lefts.size();
        if (n_l == 0 || n_l == n_sub) {
          mid = it.start + n_sub / 2 - 1;
        } else {
          std::copy(lefts.begin(), lefts.end(), order.begin() + it.start);
          std::copy(rights.begin(), rights.end(), order.begin() + it.start + n_l);
          mid = it.start + n_l - 1;
        }
      }
      // push right then left so left is processed first (stable ids)
      stack.push_back({mid + 1, it.end, my, true});
      stack.push_back({it.start, mid, my, false});
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.  Outputs go to caller buffers sized for the worst
// case: bounds* [2T-1, 3]; node_* [6 * (2T-1)], written as [6, size] with the
// actual node count as stride; leaf_tris [T, L*9]; leaf_map [T * L].  The
// actual sizes go to out_size, out_leaves, out_depth.
int radish_build_bvh(const float *vertices, int num_prims, int leaf_size,
                     float *bounds_min, float *bounds_max, int32_t *node_leaf,
                     int32_t *node_aabb, int32_t *node_miss, float *leaf_tris,
                     int32_t *leaf_map, int32_t *out_size, int32_t *out_leaves,
                     int32_t *out_depth) {
  if (num_prims <= 0 || leaf_size <= 0) return 1;
  Builder b;
  b.num_prims = num_prims;
  b.leaf_size = leaf_size;
  b.verts = vertices;
  b.prim_setup();
  b.build_tree();

  const int size = (int)b.n_bmin.size();
  const int n_leaves = (int)b.leaf_prims.size();
  const int L = leaf_size;
  *out_size = size;
  *out_leaves = n_leaves;
  *out_depth = b.depth;

  for (int i = 0; i < size; ++i) {
    bounds_min[i * 3 + 0] = b.n_bmin[i].x;
    bounds_min[i * 3 + 1] = b.n_bmin[i].y;
    bounds_min[i * 3 + 2] = b.n_bmin[i].z;
    bounds_max[i * 3 + 0] = b.n_bmax[i].x;
    bounds_max[i * 3 + 1] = b.n_bmax[i].y;
    bounds_max[i * 3 + 2] = b.n_bmax[i].z;
  }

  // leaf-major padded triangle table (v0, e1, e2) + slot map
  std::memset(leaf_tris, 0, sizeof(float) * (size_t)n_leaves * L * 9);
  for (int64_t i = 0; i < (int64_t)n_leaves * L; ++i) leaf_map[i] = -1;
  for (int row = 0; row < n_leaves; ++row) {
    const auto &ids = b.leaf_prims[row];
    for (size_t k = 0; k < ids.size(); ++k) {
      const float *p = vertices + (size_t)ids[k] * 9;
      float *dst = leaf_tris + ((size_t)row * L + k) * 9;
      dst[0] = p[0];
      dst[1] = p[1];
      dst[2] = p[2];
      dst[3] = p[3] - p[0];
      dst[4] = p[4] - p[1];
      dst[5] = p[5] - p[2];
      dst[6] = p[6] - p[0];
      dst[7] = p[7] - p[1];
      dst[8] = p[8] - p[2];
      leaf_map[(size_t)row * L + k] = ids[k];
    }
  }

  // subtree sizes (reverse topological: children always have larger ids)
  std::vector<int64_t> sub(size, 1);
  for (int i = size - 1; i >= 0; --i) {
    if (b.n_left[i] >= 0) sub[i] = 1 + sub[b.n_left[i]] + sub[b.n_right[i]];
  }

  // the 6 near-to-far threaded DFS orders
  std::vector<int32_t> stack2;
  stack2.reserve(size);
  for (int d = 0; d < 6; ++d) {
    int axis = d / 2;
    bool flip = d & 1;
    int32_t *leaf6 = node_leaf + (size_t)d * size;
    int32_t *aabb6 = node_aabb + (size_t)d * size;
    int32_t *miss6 = node_miss + (size_t)d * size;
    int new_id = 0;
    stack2.clear();
    stack2.push_back(0);
    while (!stack2.empty()) {
      int orig = stack2.back();
      stack2.pop_back();
      leaf6[new_id] = b.n_leafrow[orig];
      aabb6[new_id] = orig;
      miss6[new_id] = new_id + (int)sub[orig];
      new_id++;
      if (b.n_left[orig] < 0) continue;
      int lc = b.n_left[orig], rc = b.n_right[orig];
      float cl = (b.n_bmin[lc][axis] + b.n_bmax[lc][axis]) * 0.5f;
      float cr = (b.n_bmin[rc][axis] + b.n_bmax[rc][axis]) * 0.5f;
      int near = lc, far = rc;
      // even classes serve negative-axis rays -> larger-center child first
      if ((cl < cr) != flip) std::swap(near, far);
      stack2.push_back(far);
      stack2.push_back(near);
    }
  }
  return 0;
}
}
