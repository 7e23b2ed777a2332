// Native BVH builder of tpu_raytracer_torch (ctypes ABI): the exact-SAH
// sweep build of the JAX package's native bvh_builder.cpp, the one build
// the port uses for meshes. Built with g++ at first use by
// kernels/build.py (build_bvh_builder) and bound in accel/native.py.
//
// Same construction semantics as the numpy builder's sweep mode
// (accel/bvh.py, mode="sweep"), bit for bit:
//   * node boxes grown from triangle vertices; every split position
//     between centroid-sorted neighbours is costed per axis;
//   * cost = half_surface_area * count, first-minimum tie-break;
//   * split accepted only if best_cost < parent cost; stop at
//     depth >= max_depth or <= min_leaf_size triangles;
//   * children appended depth-first, left subtree first (node 0 root);
//   * triangles reordered so each leaf owns [start, start+count).
//
// This native path exists for Sponza-class scenes, where the numpy
// builder's per-node Python overhead dominates.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Nodes above this size always split (see the forced-split note in
// Builder::fill); must stay well under the packet kernel's
// 1023-triangle leaf cap. Mirrors accel/bvh.py FORCE_SPLIT_ABOVE.
constexpr int kForceSplitAbove = 512;

struct Box {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const float* lo, const float* hi) {
    for (int c = 0; c < 3; ++c) {
      if (lo[c] < mn[c]) mn[c] = lo[c];
      if (hi[c] > mx[c]) mx[c] = hi[c];
    }
  }
  // float arithmetic to match the numpy builder's f32 half-area
  // (accel/bvh.py _half_area) bit for bit, so both builders produce
  // identical trees.
  float half_area() const {
    float sx = mx[0] - mn[0];
    float sy = mx[1] - mn[1];
    float sz = mx[2] - mn[2];
    return sx * (sy + sz) + sy * sz;
  }
};

struct Builder {
  const float* tri_min;  // [T,3]
  const float* tri_max;  // [T,3]
  const float* cent;     // [T,3]
  int max_depth;
  int min_leaf_size;

  std::vector<float> node_min, node_max;
  std::vector<int32_t> child_a, child_b, leaf_start, leaf_count;
  std::vector<int32_t> order;

  int new_node(const Box& b) {
    node_min.insert(node_min.end(), b.mn, b.mn + 3);
    node_max.insert(node_max.end(), b.mx, b.mx + 3);
    child_a.push_back(-1);
    child_b.push_back(-1);
    leaf_start.push_back(0);
    leaf_count.push_back(0);
    return int(child_a.size()) - 1;
  }

  void make_leaf(int id, const int32_t* idx, int n) {
    leaf_start[id] = int32_t(order.size());
    leaf_count[id] = n;
    order.insert(order.end(), idx, idx + n);
  }

  // Exact SAH sweep on one axis (mirrors accel/bvh.py
  // _eval_axis_sweep bit for bit): stable-sort by centroid, prefix /
  // suffix f32 box areas, cost in f32 (numpy uses float32 counts, so
  // no f64 promotion here), first-minimum tie-break. ``ord`` receives
  // the sorted triangle ids; split is "after position k".
  void eval_axis_sweep(const int32_t* idx, int n, int ax,
                       float* best_cost, int* best_k,
                       std::vector<int32_t>& ord) const {
    ord.assign(idx, idx + n);
    std::stable_sort(ord.begin(), ord.end(), [&](int32_t a, int32_t b) {
      return cent[3 * a + ax] < cent[3 * b + ax];
    });
    // suffix boxes: rarea[i] = half_area of tris ord[i..n-1]
    std::vector<float> rarea(n);
    {
      Box r;
      for (int i = n - 1; i >= 0; --i) {
        int k = ord[i];
        r.grow(tri_min + 3 * k, tri_max + 3 * k);
        rarea[i] = r.half_area();
      }
    }
    Box l;
    *best_cost = FLT_MAX;
    *best_k = 0;
    for (int i = 0; i < n - 1; ++i) {
      int k = ord[i];
      l.grow(tri_min + 3 * k, tri_max + 3 * k);
      float cost = l.half_area() * float(i + 1) +
                   rarea[i + 1] * (float(n) - float(i + 1));
      if (cost < *best_cost) {
        *best_cost = cost;
        *best_k = i;
      }
    }
  }

  int fill(int32_t* idx, int n, int depth) {
    Box box;
    for (int i = 0; i < n; ++i)
      box.grow(tri_min + 3 * idx[i], tri_max + 3 * idx[i]);
    int id = new_node(box);

    if (depth >= max_depth || n <= (min_leaf_size > 1 ? min_leaf_size : 1)) {
      make_leaf(id, idx, n);
      return id;
    }

    float sc[3];
    int sk[3];
    std::vector<int32_t> sord[3];
    for (int ax = 0; ax < 3; ++ax)
      eval_axis_sweep(idx, n, ax, &sc[ax], &sk[ax], sord[ax]);
    // first-minimum across axes (numpy argmin)
    int axis = 0;
    if (sc[1] < sc[0]) axis = 1;
    if (sc[2] < sc[axis]) axis = 2;
    float best = sc[axis];
    int k = sk[axis];
    const std::vector<int32_t>& ord = sord[axis];

    // Forced split for oversized nodes (mirrors accel/bvh.py): the
    // strict no-gain stop deadlocks on uniform thin slabs (equal
    // half-area*count on both sides), producing leaves beyond the
    // kernel's 10-bit count cap at Sponza scale.
    float node_cost = box.half_area() * float(n);
    bool oversized = n > kForceSplitAbove;
    if (best >= node_cost && !oversized) {
      make_leaf(id, idx, n);
      return id;
    }

    // sorted-order partition: both sides always nonempty
    std::memcpy(idx, ord.data(), n * sizeof(int32_t));
    child_a[id] = fill(idx, k + 1, depth + 1);
    child_b[id] = fill(idx + k + 1, n - (k + 1), depth + 1);
    return id;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written. Output buffers must hold at
// least (2*num_tris - 1) nodes (worst case for a binary tree with >=1
// triangle per leaf) and num_tris order entries.
int32_t trt_build_bvh_sweep(const float* v0, const float* v1,
                            const float* v2, int32_t num_tris,
                            int32_t max_depth, int32_t min_leaf_size,
                            float* out_node_min, float* out_node_max,
                            int32_t* out_child_a, int32_t* out_child_b,
                            int32_t* out_leaf_start,
                            int32_t* out_leaf_count, int32_t* out_order) {
  std::vector<float> tri_min(3 * num_tris), tri_max(3 * num_tris),
      cent(3 * num_tris);
  for (int i = 0; i < num_tris; ++i) {
    for (int c = 0; c < 3; ++c) {
      float a = v0[3 * i + c], b = v1[3 * i + c], d = v2[3 * i + c];
      float lo = a < b ? a : b;
      lo = lo < d ? lo : d;
      float hi = a > b ? a : b;
      hi = hi > d ? hi : d;
      tri_min[3 * i + c] = lo;
      tri_max[3 * i + c] = hi;
      cent[3 * i + c] = (a + b + d) / 3.0f;
    }
  }

  Builder builder;
  builder.tri_min = tri_min.data();
  builder.tri_max = tri_max.data();
  builder.cent = cent.data();
  builder.max_depth = max_depth;
  builder.min_leaf_size = min_leaf_size;

  std::vector<int32_t> idx(num_tris);
  for (int i = 0; i < num_tris; ++i) idx[i] = i;

  if (num_tris == 0) {
    Box empty;
    int id = builder.new_node(empty);
    builder.make_leaf(id, idx.data(), 0);
  } else {
    builder.fill(idx.data(), num_tris, 1);
  }

  int32_t n = int32_t(builder.child_a.size());
  std::memcpy(out_node_min, builder.node_min.data(), 3 * n * sizeof(float));
  std::memcpy(out_node_max, builder.node_max.data(), 3 * n * sizeof(float));
  std::memcpy(out_child_a, builder.child_a.data(), n * sizeof(int32_t));
  std::memcpy(out_child_b, builder.child_b.data(), n * sizeof(int32_t));
  std::memcpy(out_leaf_start, builder.leaf_start.data(), n * sizeof(int32_t));
  std::memcpy(out_leaf_count, builder.leaf_count.data(), n * sizeof(int32_t));
  std::memcpy(out_order, builder.order.data(),
              builder.order.size() * sizeof(int32_t));
  return n;
}

}  // extern "C"
