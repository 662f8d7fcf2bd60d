// Area-optimal culling-cluster segmentation (windowed DP), in C++.
//
// The native twin of radish_pt_tpu_torch/scene/build.py::_cluster_cuts_numpy,
// equal to it cut for cut.  The recurrence is sequential in the triangle
// index, which holds the numpy version to one Python step a position.
//
// cost[i+1] = min over k < min(sub, i+1) of
//               cost[i-k] + area(AABB of tris (i-k .. i)) + lambda
// (f32, left to right, the first minimum), exactly per `chunk` triangles.
// As numpy does, the last chunk is padded to a whole `chunk` with copies of
// the last triangle, the DP runs over the padded length, and the cuts past
// T fall onto T.  Build with -ffp-contract=off.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// numpy's _box_area: 2 (dx dy + dy dz + dx dz) of the clamped extents, f32
inline float box_area(const float lo[3], const float hi[3]) {
  float dx = std::max(hi[0] - lo[0], 0.0f);
  float dy = std::max(hi[1] - lo[1], 0.0f);
  float dz = std::max(hi[2] - lo[2], 0.0f);
  return 2.0f * (dx * dy + dy * dz + dx * dz);
}

}  // namespace

extern "C" {

// pmin/pmax: [T, 3] f32 row-major; lam: numpy's lambda as f32; cuts_out must
// hold T + 1 entries.  Returns the number of cut positions written
// (n_segments + 1, from 0 to T, ascending).
int64_t radish_cluster_cuts(const float *pmin, const float *pmax, int64_t T,
                            int64_t sub, float lam, int64_t chunk,
                            int64_t *cuts_out) {
  if (T <= 0 || sub <= 0 || chunk <= 0) return 0;
  const float kInf = std::numeric_limits<float>::infinity();

  std::vector<int64_t> cuts;
  cuts.push_back(0);
  std::vector<float> cost(chunk + 1);
  std::vector<int64_t> back(chunk + 1);
  // the window boxes, by segment start s in slot s % win: a start leaves the
  // window (k = sub) before its slot is taken again
  const int64_t win = std::min(sub, chunk);
  std::vector<float> lo(win * 3), hi(win * 3);

  for (int64_t base = 0; base < T; base += chunk) {
    std::fill(cost.begin(), cost.end(), 0.0f);
    std::fill(back.begin(), back.end(), 0);
    for (int64_t i = 0; i < chunk; ++i) {
      const int64_t g = std::min(base + i, T - 1);  // the padding repeats T - 1
      const float *tmin = pmin + g * 3;
      const float *tmax = pmax + g * 3;
      const int64_t kmax = std::min(sub, i + 1);
      const int64_t fresh = (i % win) * 3;  // the segment that starts at i
      std::fill_n(lo.data() + fresh, 3, kInf);
      std::fill_n(hi.data() + fresh, 3, -kInf);
      float best = kInf;
      int64_t best_start = i;
      for (int64_t k = 0; k < kmax; ++k) {  // grow (i-k .. i-1) by i, cost it
        const int64_t s = ((i - k) % win) * 3;
        float *l = lo.data() + s;
        float *h = hi.data() + s;
        for (int a = 0; a < 3; ++a) {
          l[a] = std::min(l[a], tmin[a]);
          h[a] = std::max(h[a], tmax[a]);
        }
        const float c = cost[i - k] + box_area(l, h) + lam;
        if (c < best) {
          best = c;
          best_start = i - k;
        }
      }
      cost[i + 1] = best;
      back[i + 1] = best_start;
    }
    for (int64_t i = chunk; i > 0; i = back[i]) cuts.push_back(std::min(base + i, T));
  }

  std::sort(cuts.begin(), cuts.end());
  cuts.erase(std::unique(cuts.begin(), cuts.end()), cuts.end());
  std::copy(cuts.begin(), cuts.end(), cuts_out);
  return static_cast<int64_t>(cuts.size());
}

}  // extern "C"
