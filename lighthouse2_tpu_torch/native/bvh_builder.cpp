// Native binned-SAH BVH2 builder (C ABI, loaded via ctypes).
//
// A copy of lighthouse2_tpu/native/bvh_builder.cpp, kept byte for byte in
// its code so that both packages build the same tree on one machine with the
// same flags (g++ -O3 -std=c++17 -shared -fPIC). The reference builds its BVH
// in C++ with per-node recursion: 8-bin centroid SAH over x/y/z with
// SplitCost = count x AABB-half-area (RenderCore_Bart/bvh.cpp:57-178). This
// builder keeps that algorithm and emits the flattened DFS-preorder (left
// child first) layout of the numpy builder (lighthouse2_tpu_torch/bvh/
// builder.py build_sah_bvh_numpy); the two differ in how they break ties, so
// their trees can differ:
//
//   nmin, nmax  [N,3] f32   node bounds
//   left        [N]   i32   interior: left child id (== id+1); leaf: first prim
//   right       [N]   i32   interior: right child id; leaf: -1
//   count       [N]   i32   0 = interior, >0 = leaf primitive count
//   prim        [T]   i32   triangle ids, contiguous per leaf
//
// Split rule (parity with the numpy builder): a node with count <= max_leaf
// is always a leaf; above the cap it MUST split — SAH picks the plane, and a
// median split on the largest centroid axis is the fallback when every SAH
// candidate leaves one side empty (degenerate centroids).
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const Vec3 &lo2, const Vec3 &hi2) {
    lo = vmin(lo, lo2);
    hi = vmax(hi, hi2);
  }
  void grow(const AABB &o) { grow(o.lo, o.hi); }
  float half_area() const {
    float ex = std::max(hi.x - lo.x, 0.0f);
    float ey = std::max(hi.y - lo.y, 0.0f);
    float ez = std::max(hi.z - lo.z, 0.0f);
    return ex * ey + ey * ez + ez * ex;
  }
};

struct Task {
  int32_t first, count;   // prim range [first, first+count)
  int32_t parent;         // node id of parent, -1 for root
  bool is_right;          // true -> fix up parent's right pointer
};

}  // namespace

extern "C" {

// Returns number of nodes written, or -1 if `cap` nodes is not enough.
// All output buffers are caller-allocated: nmin/nmax cap*3 floats,
// left/right/count cap ints, prim t_count ints. cap = 2*t_count is always
// sufficient (every interior node has 2 children; leaves hold >= 1 prim).
int lh2_build_bvh(const float *v0, const float *v1, const float *v2,
                  int32_t t_count, int32_t max_leaf, int32_t bins_req,
                  float *nmin, float *nmax, int32_t *left, int32_t *right,
                  int32_t *count, int32_t *prim, int32_t cap) {
  if (t_count <= 0 || cap < 1) return -1;
  const int BINS = bins_req > 1 ? (bins_req > 64 ? 64 : bins_req) : 8;

  std::vector<Vec3> tmin(t_count), tmax(t_count), cent(t_count);
  for (int32_t i = 0; i < t_count; i++) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    Vec3 c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    tmin[i] = vmin(vmin(a, b), c);
    tmax[i] = vmax(vmax(a, b), c);
    cent[i] = {0.5f * (tmin[i].x + tmax[i].x), 0.5f * (tmin[i].y + tmax[i].y),
               0.5f * (tmin[i].z + tmax[i].z)};
    prim[i] = i;
  }

  std::vector<AABB> bin_box(3 * BINS);
  std::vector<int32_t> bin_cnt(3 * BINS);
  std::vector<Task> stack;
  stack.reserve(64);
  stack.push_back({0, t_count, -1, false});
  int32_t n_nodes = 0;

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    if (n_nodes >= cap) return -1;
    const int32_t id = n_nodes++;
    if (task.parent >= 0 && task.is_right) right[task.parent] = id;

    // node + centroid bounds over the range
    AABB nb, cb;
    for (int32_t i = task.first; i < task.first + task.count; i++) {
      const int32_t p = prim[i];
      nb.grow(tmin[p], tmax[p]);
      cb.grow(cent[p], cent[p]);
    }
    nmin[3 * id] = nb.lo.x; nmin[3 * id + 1] = nb.lo.y; nmin[3 * id + 2] = nb.lo.z;
    nmax[3 * id] = nb.hi.x; nmax[3 * id + 1] = nb.hi.y; nmax[3 * id + 2] = nb.hi.z;

    if (task.count <= max_leaf) {            // leaf (hard cap rule)
      left[id] = task.first;
      right[id] = -1;
      count[id] = task.count;
      continue;
    }

    // --- binned SAH over x/y/z (bvh.cpp:96-178 semantics) ----------------
    const float cext[3] = {std::max(cb.hi.x - cb.lo.x, 1e-12f),
                           std::max(cb.hi.y - cb.lo.y, 1e-12f),
                           std::max(cb.hi.z - cb.lo.z, 1e-12f)};
    const float clo[3] = {cb.lo.x, cb.lo.y, cb.lo.z};
    std::fill(bin_cnt.begin(), bin_cnt.end(), 0);
    std::fill(bin_box.begin(), bin_box.end(), AABB{});
    for (int32_t i = task.first; i < task.first + task.count; i++) {
      const int32_t p = prim[i];
      const float c[3] = {cent[p].x, cent[p].y, cent[p].z};
      for (int ax = 0; ax < 3; ax++) {
        int b = (int)((c[ax] - clo[ax]) / cext[ax] * BINS);
        b = b < 0 ? 0 : (b >= BINS ? BINS - 1 : b);
        bin_cnt[ax * BINS + b]++;
        bin_box[ax * BINS + b].grow(tmin[p], tmax[p]);
      }
    }

    float best_cost = std::numeric_limits<float>::infinity();
    int best_axis = -1, best_bin = -1;
    for (int ax = 0; ax < 3; ax++) {
      AABB lbox[64];
      int32_t lcnt[64];
      AABB acc;
      int32_t c = 0;
      for (int b = 0; b < BINS - 1; b++) {
        acc.grow(bin_box[ax * BINS + b]);
        c += bin_cnt[ax * BINS + b];
        lbox[b] = acc;
        lcnt[b] = c;
      }
      AABB racc;
      int32_t rc = 0;
      for (int b = BINS - 1; b >= 1; b--) {
        racc.grow(bin_box[ax * BINS + b]);
        rc += bin_cnt[ax * BINS + b];
        const int k = b - 1;  // split after bin k
        if (lcnt[k] == 0 || rc == 0) continue;
        const float cost = (float)lcnt[k] * lbox[k].half_area() +
                           (float)rc * racc.half_area();
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = ax;
          best_bin = k;
        }
      }
    }

    // partition prims in place
    int32_t mid;
    if (best_axis >= 0) {
      int32_t i = task.first, j = task.first + task.count - 1;
      while (i <= j) {
        const int32_t p = prim[i];
        const float c = best_axis == 0 ? cent[p].x
                        : best_axis == 1 ? cent[p].y : cent[p].z;
        int b = (int)((c - clo[best_axis]) / cext[best_axis] * BINS);
        b = b < 0 ? 0 : (b >= BINS ? BINS - 1 : b);
        if (b <= best_bin) {
          i++;
        } else {
          std::swap(prim[i], prim[j--]);
        }
      }
      mid = i;
    } else {
      // median fallback on largest centroid axis
      int ax = 0;
      if (cext[1] > cext[ax]) ax = 1;
      if (cext[2] > cext[ax]) ax = 2;
      mid = task.first + task.count / 2;
      std::nth_element(
          prim + task.first, prim + mid, prim + task.first + task.count,
          [&](int32_t a, int32_t b) {
            const float ca = ax == 0 ? cent[a].x : ax == 1 ? cent[a].y : cent[a].z;
            const float cb2 = ax == 0 ? cent[b].x : ax == 1 ? cent[b].y : cent[b].z;
            return ca < cb2;
          });
    }
    if (mid == task.first || mid == task.first + task.count)
      mid = task.first + task.count / 2;   // guarantee progress

    count[id] = 0;
    left[id] = id + 1;  // DFS preorder: left child follows immediately
    // push right FIRST so left pops first (preorder, left child first)
    stack.push_back({mid, task.first + task.count - mid, id, true});
    stack.push_back({task.first, mid - task.first, id, false});
  }
  return n_nodes;
}

// Sanity/version probe for the ctypes loader.
int lh2_native_abi_version(void) { return 1; }

}  // extern "C"
