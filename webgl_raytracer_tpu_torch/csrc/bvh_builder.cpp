// Binned-SAH BVH builder — the native scene-compile hot loop (host C++,
// built with g++ by scene/native.py; the port's own copy of the JAX
// package's webgl_raytracer_tpu/native/bvh_builder.cpp, byte for byte below
// this header so both packages build identical BVHs).
//
// Same algorithm and outputs as the Python builder in scene/bvh.py: 8 SAH
// bins over the centroid extent per axis, best-cost
// split with a median fallback when a side comes up empty, preorder node
// emission, leaves referencing a contiguous range of the reordered
// primitive list. Iterative with an explicit stack; node slots are
// allocated at pop time with left children pushed last, which reproduces
// preorder numbering without recursion.
//
// C ABI for ctypes:
//   int wrt_build_bvh(
//       const float* bmin, const float* bmax, const float* centroid,  // [n,3]
//       long long n, int max_leaf, int max_depth,
//       float* node_bmin, float* node_bmax,   // capacity 2n nodes x 3
//       int*   node_meta,                     // [2n,3] (leftFirst, primCount, rightChild)
//       long long* prim_order)                // [n]
// Returns the node count (>= 1), or -1 on error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 8;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Box {
  float lo[3] = {kInf, kInf, kInf};
  float hi[3] = {-kInf, -kInf, -kInf};

  void grow(const float* lo_in, const float* hi_in) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], lo_in[a]);
      hi[a] = std::max(hi[a], hi_in[a]);
    }
  }
  void grow(const Box& b) { grow(b.lo, b.hi); }
  float area() const {
    float dx = std::max(0.0f, hi[0] - lo[0]);
    float dy = std::max(0.0f, hi[1] - lo[1]);
    float dz = std::max(0.0f, hi[2] - lo[2]);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Task {
  int64_t begin;
  int64_t end;
  int depth;
  int64_t parent_slot;  // -1 for the root
  int is_right;         // which parent meta field to patch
};

}  // namespace

extern "C" int wrt_build_bvh(
    const float* bmin, const float* bmax, const float* centroid,
    long long n_in, int max_leaf, int max_depth,
    float* node_bmin, float* node_bmax, int* node_meta,
    long long* prim_order) {
  const int64_t n = n_in;
  if (n <= 0) return -1;

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;

  int64_t node_count = 0;
  int64_t leaf_cursor = 0;

  std::vector<Task> stack;
  stack.reserve(2 * max_depth + 4);
  stack.push_back({0, n, 0, -1, 0});

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    const int64_t begin = task.begin, end = task.end;
    const int64_t count = end - begin;
    const int64_t slot = node_count++;
    if (task.parent_slot >= 0) {
      node_meta[task.parent_slot * 3 + (task.is_right ? 2 : 0)] =
          static_cast<int>(slot);
    }

    Box bounds;
    for (int64_t i = begin; i < end; ++i) {
      bounds.grow(bmin + order[i] * 3, bmax + order[i] * 3);
    }
    std::memcpy(node_bmin + slot * 3, bounds.lo, 12);
    std::memcpy(node_bmax + slot * 3, bounds.hi, 12);

    bool make_leaf = count <= max_leaf || task.depth >= max_depth;
    int best_axis = -1;
    int best_bin = -1;
    float cmin[3], cmax[3];

    if (!make_leaf) {
      for (int a = 0; a < 3; ++a) {
        cmin[a] = kInf;
        cmax[a] = -kInf;
      }
      for (int64_t i = begin; i < end; ++i) {
        const float* c = centroid + order[i] * 3;
        for (int a = 0; a < 3; ++a) {
          cmin[a] = std::min(cmin[a], c[a]);
          cmax[a] = std::max(cmax[a], c[a]);
        }
      }

      float best_cost = kInf;
      for (int axis = 0; axis < 3; ++axis) {
        const float span = cmax[axis] - cmin[axis];
        if (span <= 0.0f) continue;
        const float scale = kBins / span;

        int bin_count[kBins] = {0};
        Box bin_box[kBins];
        for (int64_t i = begin; i < end; ++i) {
          const int64_t p = order[i];
          int b = static_cast<int>((centroid[p * 3 + axis] - cmin[axis]) * scale);
          b = std::min(std::max(b, 0), kBins - 1);
          bin_count[b]++;
          bin_box[b].grow(bmin + p * 3, bmax + p * 3);
        }

        Box left_box[kBins];
        int left_cnt[kBins];
        {
          Box acc;
          int acc_cnt = 0;
          for (int b = 0; b < kBins; ++b) {
            if (bin_count[b] > 0) acc.grow(bin_box[b]);
            acc_cnt += bin_count[b];
            left_box[b] = acc;
            left_cnt[b] = acc_cnt;
          }
        }
        Box right_box[kBins];
        int right_cnt[kBins];
        {
          Box acc;
          int acc_cnt = 0;
          for (int b = kBins - 1; b >= 0; --b) {
            if (bin_count[b] > 0) acc.grow(bin_box[b]);
            acc_cnt += bin_count[b];
            right_box[b] = acc;
            right_cnt[b] = acc_cnt;
          }
        }
        for (int b = 0; b < kBins - 1; ++b) {
          if (left_cnt[b] == 0 || right_cnt[b + 1] == 0) continue;
          const float cost = left_box[b].area() * left_cnt[b]
                           + right_box[b + 1].area() * right_cnt[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_bin = b;
          }
        }
      }
      if (best_axis < 0) make_leaf = true;
    }

    if (!make_leaf) {
      const float split = cmin[best_axis]
          + (best_bin + 1) / static_cast<float>(kBins)
            * (cmax[best_axis] - cmin[best_axis]);
      // Stable partition preserves relative order (like the JS filter
      // loops), so the median fallback slices the same prefix.
      auto mid_it = std::stable_partition(
          order.begin() + begin, order.begin() + end,
          [&](int64_t p) { return centroid[p * 3 + best_axis] < split; });
      int64_t mid = mid_it - order.begin();
      if (mid == begin || mid == end) {
        mid = begin + count / 2;
      }
      node_meta[slot * 3 + 1] = 0;
      // Right pushed first so the left child pops (and numbers) first.
      stack.push_back({mid, end, task.depth + 1, slot, 1});
      stack.push_back({begin, mid, task.depth + 1, slot, 0});
      continue;
    }

    node_meta[slot * 3 + 0] = static_cast<int>(leaf_cursor);
    node_meta[slot * 3 + 1] = static_cast<int>(count);
    node_meta[slot * 3 + 2] = -1;
    for (int64_t i = begin; i < end; ++i) {
      prim_order[leaf_cursor++] = order[i];
    }
  }

  return static_cast<int>(node_count);
}
