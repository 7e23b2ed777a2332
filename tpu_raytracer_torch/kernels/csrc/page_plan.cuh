// The page-major plan of kernel K6 (paged_major.cu), computed on the card
// with no host sync (page_plan.cu): the order in which the (instance,
// page) items are swept, front to back, and for each tile of kTileRays
// consecutive rays the items the tile may see.
//
// Counterpart of the plain version kernels/paged_major.py:page_major_plan
// (the JAX package's _tile_bounds and _item_plan of
// tpu_raytracer/kernels/paged_major.py, plain jnp beside its Pallas
// kernel), and equal to it bit for bit in item order and per-tile lists:
//   1. per tile and instance: the bounds of the tile's object-space
//      origins and reciprocal directions (pad rays repeat the last ray),
//      widened (TileBounds, bounds_widen);
//   2. per (tile, item): the interval slab test of the page's root box,
//      out-rounded, with page ownership (item_test), which gives the
//      wanted bit and near_lo; each item's key is the least near_lo over
//      the tiles that want it, and each tile counts its wanted items;
//   3. the items ranked by (key, item index) (item_rank): the plain
//      version's stable sort, unseen items (key +inf) last; the tiles'
//      list starts, a prefix sum of their counts;
//   4. per tile, the plan positions of its wanted items, ascending.
// Every f32 operation is the plain version's, in its order (fmad off).
// A min or max selects one of its operands, so the order of a reduction
// cannot change its value, only the sign of a zero result; widening maps
// +0 and -0 to the same bounds, and no comparison here tells them apart.
// An item that no tile sees keeps the key +inf, sorts last and appears in
// no tile's list, so the host never needs the count of seen items.
//
// Plain C++ for nvcc and a host compiler (traverse_host.cpp runs the same
// functions on the CPU for the tests).
#pragma once

#include "paged_traverse.cuh"

namespace wt {

// kernels/paged_major.py FRUSTUM_REL and FRUSTUM_ABS, and the page box's
// out-rounding (1e-6 relative, 1e-9 absolute): each is the f32 that
// PyTorch makes of the Python float, a cast from double.
constexpr float kFrustumRel = static_cast<float>(4e-6);
constexpr float kFrustumAbs = static_cast<float>(1e-12);
constexpr float kBoxRel = static_cast<float>(1e-6);
constexpr float kBoxAbs = static_cast<float>(1e-9);

// Bounds of one tile's object-space rays for one instance: [0..2] origin,
// [3..5] reciprocal direction.
struct TileBounds {
  float lo[6];
  float hi[6];
};

// The six values of one ray that the bounds cover.
WT_HD void bounds_values(const float* o, const float* inv, float* v) {
  for (int a = 0; a < 3; ++a) {
    v[a] = o[a];
    v[3 + a] = inv[a];
  }
}

// _widen of kernels/paged_major.py, same f32 operations.
WT_HD float widen_lo(float lo) { return lo - (fabsf(lo) * kFrustumRel + kFrustumAbs); }
WT_HD float widen_hi(float hi) { return hi + (fabsf(hi) * kFrustumRel + kFrustumAbs); }

WT_HD void bounds_widen(TileBounds& b) {
  for (int q = 0; q < 6; ++q) {
    b.lo[q] = widen_lo(b.lo[q]);
    b.hi[q] = widen_hi(b.hi[q]);
  }
}

// The least and greatest of the four interval products n * inv
// (page_major_plan's `products`).
WT_HD void products(float n_lo, float n_hi, float inv_lo, float inv_hi, float* lo, float* hi) {
  const float p0 = n_lo * inv_lo;
  const float p1 = n_lo * inv_hi;
  const float p2 = n_hi * inv_lo;
  const float p3 = n_hi * inv_hi;
  *lo = fminf(fminf(p0, p1), fminf(p2, p3));
  *hi = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
}

// Whether a tile whose widened bounds are `b` may see the page whose root
// box is (bmin, bmax) (node_min/node_max of its root node, out-rounded
// here), for an instance that owns the page (`owned`); `near_lo` gets the
// least entry distance any ray of the tile can have. No operand is NaN:
// boxes and origins are finite and |inv| stays near 1e30 at most.
WT_HD bool item_test(const TileBounds& b, const float* bmin, const float* bmax, bool owned,
                     float* near_lo) {
  float near_ = 0.0f, far_ = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float pad = (bmax[a] - bmin[a]) * kBoxRel + kBoxAbs;
    const float lo = bmin[a] - pad;
    const float hi = bmax[a] + pad;
    float t1_lo, t1_hi, t2_lo, t2_hi;
    products(lo - b.hi[a], lo - b.lo[a], b.lo[3 + a], b.hi[3 + a], &t1_lo, &t1_hi);
    products(hi - b.hi[a], hi - b.lo[a], b.lo[3 + a], b.hi[3 + a], &t2_lo, &t2_hi);
    const float n = fminf(t1_lo, t2_lo);
    const float f = fmaxf(t1_hi, t2_hi);
    near_ = a == 0 ? n : fmaxf(near_, n);
    far_ = a == 0 ? f : fminf(far_, f);
  }
  *near_lo = near_;
  return (far_ >= near_) && (far_ > 0.0f) && owned;
}

// Plan position of item k: the count of items before it in a stable sort
// by key (a smaller key, or an equal key and a lower index).
WT_HD int32_t item_rank(const float* key, int32_t num_items, int32_t k) {
  const float v = key[k];
  int32_t r = 0;
  for (int32_t j = 0; j < num_items; ++j) {
    const float u = key[j];
    r += (u < v || (u == v && j < k)) ? 1 : 0;
  }
  return r;
}

// The inputs of a plan: rays in tile order, the instances, each page's
// root node and the meshes' root nodes.
struct PlanInput {
  const float* origin;  // [3] or [R, 3]
  int origin_stride;    // 0 or 3
  const float* dirs;    // [R, 3]
  int64_t num_rays;
  const float* inst_tab;      // [I, 12]
  const int32_t* inst_mesh;   // [I]
  int num_instances;
  const float* node_min;      // [N, 3] the scene's BVH node boxes
  const float* node_max;      // [N, 3]
  const int32_t* page_node0;  // [P] root node of each page
  int num_pages;
  const int32_t* mesh_root;   // [M] root node of each mesh, ascending
  int num_meshes;

  WT_HDM int64_t num_tiles() const { return (num_rays + kTileRays - 1) / kTileRays; }
  WT_HDM int32_t num_items() const { return num_instances * num_pages; }

  // Ray `slot` of tile `tile`, the last ray for the pad slots.
  WT_HDM void ray(int64_t tile, int slot, float* wo, float* wd) const {
    int64_t r = tile * kTileRays + slot;
    if (r > num_rays - 1) r = num_rays - 1;
    for (int a = 0; a < 3; ++a) {
      wo[a] = origin[r * origin_stride + a];
      wd[a] = dirs[3 * r + a];
    }
  }

  // The mesh that owns node n0: the last mesh whose root is at or before
  // it (the plain version's searchsorted(mesh_root, node0, right=True) - 1).
  WT_HDM int32_t mesh_of(int64_t n0) const {
    int32_t lo = 0, hi = num_meshes;
    while (lo < hi) {
      const int32_t mid = (lo + hi) / 2;
      if (mesh_root[mid] <= n0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo - 1;
  }

  // item_test of item k (instance k / P, page k % P) for a tile's bounds.
  WT_HDM bool test(const TileBounds& b, int32_t k, float* near_lo) const {
    const int32_t i = k / num_pages;
    const int32_t p = k - i * num_pages;
    const int64_t n0 = page_node0[p];
    return item_test(b, node_min + 3 * n0, node_max + 3 * n0, mesh_of(n0) == inst_mesh[i],
                     near_lo);
  }
};

// A plan's scratch and outputs: K = I * P items, T tiles.
struct PlanOutput {
  uint8_t* wanted;       // [T, K] 1: the tile may see the item (item index order)
  int32_t* tile_count;   // [T] wanted items per tile
  float* key;            // [K] least near_lo of each item over the tiles that want it
  int32_t* item_pid;     // [K] page of the item at each plan position
  int32_t* item_iid;     // [K] its instance
  int32_t* tile_start;   // [T + 1] exclusive prefix sum of tile_count
  int32_t* tile_item;    // [T * K] capacity; each tile's plan positions
};

}  // namespace wt
