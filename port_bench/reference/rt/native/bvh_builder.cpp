// Binned-SAH BVH builder (C++), the native replacement for the
// GPU-side acceleration-structure build the reference gets from Vulkan
// (vkCmdBuildAccelerationStructuresKHR, rene/src/main.rs:2417-2908).
//
// Exposed to Python via a plain C ABI (ctypes); produces the same SoA node
// layout rene_tpu_torch.ops.bvh.BVH consumes:
//   aabb_min/aabb_max (M,3) f32, left/right (M,) i32, is_leaf (M,) u8,
//   order (N,) i32 — node 0 is the root; internal: left/right = child node
//   ids; leaf: left = prim range start (into `order`), right = count.
//
// Algorithm: top-down, 16-bin SAH on the widest centroid axis, with a
// median-split fallback when binning degenerates; leaves at <= leaf_size
// prims or when splitting does not beat the leaf cost.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

constexpr int kBins = 16;

struct Task {
  int32_t node, start, end;
};

}  // namespace

extern "C" int32_t rene_build_bvh(const float *tris, int32_t n_tris,
                                  int32_t leaf_size, float *aabb_min,
                                  float *aabb_max, int32_t *left,
                                  int32_t *right, uint8_t *is_leaf,
                                  int32_t *order) {
  if (n_tris <= 0) return 0;

  std::vector<AABB> boxes(n_tris);
  std::vector<Vec3> centroid(n_tris);
  for (int32_t i = 0; i < n_tris; ++i) {
    const float *t = tris + 9 * i;
    AABB b;
    b.grow(Vec3{t[0], t[1], t[2]});
    b.grow(Vec3{t[3], t[4], t[5]});
    b.grow(Vec3{t[6], t[7], t[8]});
    boxes[i] = b;
    centroid[i] = {0.5f * (b.lo.x + b.hi.x), 0.5f * (b.lo.y + b.hi.y),
                   0.5f * (b.lo.z + b.hi.z)};
    order[i] = i;
  }

  int32_t n_nodes = 1;
  std::vector<Task> stack;
  stack.push_back({0, 0, n_tris});

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    const int32_t node = task.node;
    const int32_t start = task.start, end = task.end;
    const int32_t count = end - start;

    AABB bounds, cbounds;
    for (int32_t i = start; i < end; ++i) {
      bounds.grow(boxes[order[i]]);
      const Vec3 &c = centroid[order[i]];
      cbounds.grow(c);
    }
    std::memcpy(aabb_min + 3 * node, &bounds.lo, 12);
    std::memcpy(aabb_max + 3 * node, &bounds.hi, 12);

    auto make_leaf = [&]() {
      is_leaf[node] = 1;
      left[node] = start;
      right[node] = count;
    };

    if (count <= leaf_size) {
      make_leaf();
      continue;
    }

    // widest centroid axis
    float ext[3] = {cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                    cbounds.hi.z - cbounds.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid = -1;
    if (ext[axis] > 1e-12f) {
      // binned SAH
      const float clo = axis == 0 ? cbounds.lo.x
                        : axis == 1 ? cbounds.lo.y
                                    : cbounds.lo.z;
      const float inv = kBins / ext[axis];
      AABB bin_bounds[kBins];
      int32_t bin_count[kBins] = {0};
      auto bin_of = [&](int32_t prim) {
        const Vec3 &c = centroid[prim];
        const float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
        int b = static_cast<int>((v - clo) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int32_t i = start; i < end; ++i) {
        const int b = bin_of(order[i]);
        bin_bounds[b].grow(boxes[order[i]]);
        bin_count[b]++;
      }
      // sweep: suffix areas
      float right_area[kBins];
      AABB acc;
      int32_t acc_n = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_bounds[b]);
        acc_n += bin_count[b];
        right_area[b] = acc_n ? acc.half_area() * acc_n : 0.f;
      }
      AABB lacc;
      int32_t lacc_n = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bin_bounds[b]);
        lacc_n += bin_count[b];
        if (lacc_n == 0 || lacc_n == count) continue;
        const float cost = lacc.half_area() * lacc_n + right_area[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      const float leaf_cost = bounds.half_area() * count;
      if (best_split >= 0 &&
          (count > 4 * leaf_size || best_cost < leaf_cost)) {
        auto it = std::partition(order + start, order + end,
                                 [&](int32_t p) {
                                   return bin_of(p) <= best_split;
                                 });
        mid = static_cast<int32_t>(it - order);
        if (mid == start || mid == end) mid = -1;
      }
    }
    if (mid < 0) {
      // median fallback
      mid = start + count / 2;
      std::nth_element(order + start, order + mid, order + end,
                       [&](int32_t a, int32_t b) {
                         const Vec3 &ca = centroid[a];
                         const Vec3 &cb = centroid[b];
                         const float va =
                             axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
                         const float vb =
                             axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z;
                         return va < vb;
                       });
    }

    const int32_t lnode = n_nodes, rnode = n_nodes + 1;
    n_nodes += 2;
    is_leaf[node] = 0;
    left[node] = lnode;
    right[node] = rnode;
    stack.push_back({lnode, start, mid});
    stack.push_back({rnode, mid, end});
  }
  return n_nodes;
}
