// Native BVH builder: binned-SAH, flat skip-link output.
//
// The reference builds its BVH in C++ on the host (SURVEY.md §2.1 R6); this
// is the framework's native equivalent for large scenes (the 2M-triangle
// config 5, BASELINE.json:11), where the pure-numpy median-split builder in
// accel/build.py is too slow. Output layout is IDENTICAL to the numpy
// builder's contract (depth-first preorder, skip links, leaf-contiguous
// triangle order) so accel/traverse.py consumes either interchangeably; quality is higher (SAH) which also shortens
// traversal.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment):
//   int bvh_build(const float* tris,  // (n_tris, 9): v0,v1,v2 xyz
//                 int n_tris, int max_leaf,
//                 float* out_lo, float* out_hi,      // (2*n_tris, 3)
//                 int* out_first, int* out_count,    // (2*n_tris,)
//                 int* out_skip, int* out_order)     // (2*n_tris,) / (n_tris,)
//   returns node count (<= 2*n_tris), or -1 on error.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(0.0f, hi.x - lo.x);
    float dy = std::max(0.0f, hi.y - lo.y);
    float dz = std::max(0.0f, hi.z - lo.z);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float* tris;
  int max_leaf;
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  // Flat output in DFS preorder.
  std::vector<float> lo, hi;
  std::vector<int> first, count, skip;
  std::vector<int> order;

  static constexpr int kBins = 16;

  int emit_node(const AABB& box) {
    lo.push_back(box.lo.x);
    lo.push_back(box.lo.y);
    lo.push_back(box.lo.z);
    hi.push_back(box.hi.x);
    hi.push_back(box.hi.y);
    hi.push_back(box.hi.z);
    first.push_back(0);
    count.push_back(0);
    skip.push_back(-1);
    return static_cast<int>(count.size()) - 1;
  }

  // Recursive DFS build over ids[begin, end). Recursion depth is O(log T)
  // in practice (SAH splits are balanced-ish); a 2M-tri scene stays well
  // under any stack limit because degenerate splits fall back to median.
  void build(std::vector<int>& ids, int begin, int end) {
    AABB box;
    AABB cbox;
    for (int i = begin; i < end; ++i) {
      box.grow(tri_box[ids[i]]);
      cbox.grow(centroid[ids[i]]);
    }
    int me = emit_node(box);
    int n = end - begin;
    if (n <= max_leaf) {
      first[me] = static_cast<int>(order.size());
      count[me] = n;
      for (int i = begin; i < end; ++i) order.push_back(ids[i]);
      skip[me] = static_cast<int>(count.size());
      return;
    }

    // Binned SAH over the widest centroid axis.
    float ext[3] = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                    cbox.hi.z - cbox.lo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    float cmin = axis == 0 ? cbox.lo.x : (axis == 1 ? cbox.lo.y : cbox.lo.z);
    float cext = ext[axis];

    int mid;
    if (cext <= 1e-12f) {
      mid = begin + n / 2;  // all centroids identical: split by halves
    } else {
      AABB bin_box[kBins];
      int bin_cnt[kBins] = {0};
      auto bin_of = [&](int t) {
        float c = axis == 0 ? centroid[t].x
                            : (axis == 1 ? centroid[t].y : centroid[t].z);
        int b = static_cast<int>((c - cmin) / cext * kBins);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = begin; i < end; ++i) {
        int b = bin_of(ids[i]);
        bin_box[b].grow(tri_box[ids[i]]);
        bin_cnt[b]++;
      }
      // Sweep for the best split plane by SAH cost.
      AABB right_acc[kBins];
      AABB acc;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bin_box[b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int left_n = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        left_acc.grow(bin_box[b]);
        left_n += bin_cnt[b];
        int right_n = n - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = left_acc.area() * left_n + right_acc[b + 1].area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = begin + n / 2;
        // Median fallback needs a sorted-by-centroid range.
        std::nth_element(
            ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
            [&](int a, int b) {
              float ca = axis == 0 ? centroid[a].x
                                   : (axis == 1 ? centroid[a].y : centroid[a].z);
              float cb = axis == 0 ? centroid[b].x
                                   : (axis == 1 ? centroid[b].y : centroid[b].z);
              return ca < cb;
            });
      } else {
        auto it = std::partition(
            ids.begin() + begin, ids.begin() + end,
            [&](int t) { return bin_of(t) <= best_split; });
        mid = static_cast<int>(it - ids.begin());
        if (mid == begin || mid == end) mid = begin + n / 2;
      }
    }

    build(ids, begin, mid);   // near child at me+1
    build(ids, mid, end);     // far child
    skip[me] = static_cast<int>(count.size());
  }
};

}  // namespace

extern "C" int bvh_build(const float* tris, int n_tris, int max_leaf,
                         float* out_lo, float* out_hi, int* out_first,
                         int* out_count, int* out_skip, int* out_order) {
  if (n_tris <= 0 || max_leaf <= 0) return -1;
  Builder b;
  b.tris = tris;
  b.max_leaf = max_leaf;
  b.tri_box.resize(n_tris);
  b.centroid.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    const float* t = tris + 9 * i;
    Vec3 p0{t[0], t[1], t[2]}, p1{t[3], t[4], t[5]}, p2{t[6], t[7], t[8]};
    AABB box;
    box.grow(p0);
    box.grow(p1);
    box.grow(p2);
    b.tri_box[i] = box;
    b.centroid[i] = {(box.lo.x + box.hi.x) * 0.5f,
                     (box.lo.y + box.hi.y) * 0.5f,
                     (box.lo.z + box.hi.z) * 0.5f};
  }
  size_t cap = 2 * static_cast<size_t>(n_tris);
  b.lo.reserve(cap * 3);
  b.hi.reserve(cap * 3);
  b.first.reserve(cap);
  b.count.reserve(cap);
  b.skip.reserve(cap);
  b.order.reserve(n_tris);
  std::vector<int> ids(n_tris);
  for (int i = 0; i < n_tris; ++i) ids[i] = i;
  b.build(ids, 0, n_tris);

  int n_nodes = static_cast<int>(b.count.size());
  if (static_cast<size_t>(n_nodes) > cap) return -1;  // contract violation
  std::memcpy(out_lo, b.lo.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_hi, b.hi.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_first, b.first.data(), sizeof(int) * n_nodes);
  std::memcpy(out_count, b.count.data(), sizeof(int) * n_nodes);
  std::memcpy(out_skip, b.skip.data(), sizeof(int) * n_nodes);
  std::memcpy(out_order, b.order.data(), sizeof(int) * n_tris);
  return n_nodes;
}
