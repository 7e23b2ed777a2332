// Host builds of the traversal headers for the CPU tests: the same
// per-ray code the CUDA kernels K1 and K2 (walk.cuh), K3
// (tlas_traverse.cuh) and K4-K6 (paged_traverse.cuh) run, looped over
// rays, and the per-tile and per-item functions of K6's plan
// (page_plan.cuh) looped over tiles and items. WT_HOST_SHORT_STACK is S,
// the ring slots of the short stack of K1-K6 (a power of two): a build
// with a tiny S takes the spill path.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -DWT_HOST_SHORT_STACK=16 -o libtraverse_host.so traverse_host.cpp
#include "page_plan.cuh"
#include "tlas_traverse.cuh"

#ifndef WT_HOST_SHORT_STACK
#error "build with -DWT_HOST_SHORT_STACK=<S>"
#endif

namespace {

constexpr int kShortStack = WT_HOST_SHORT_STACK;
static_assert(kShortStack >= 1 && (kShortStack & (kShortStack - 1)) == 0,
              "S must be a power of two");

// One short stack per ray, as a thread on the card starts each ray.
struct HostStack {
  int32_t ring[kShortStack];
  int32_t spill[wt::kStack];
  int64_t spills = 0;

  wt::ShortStack fresh() { return wt::ShortStack(ring, 1, kShortStack - 1, spill); }
};

template <class Trace>
void trace_all(int64_t num_rays, float* t_out, int32_t* tri_out, int32_t* inst_out,
               int64_t* spills, Trace&& trace) {
  HostStack hs;
  for (int64_t r = 0; r < num_rays; ++r) {
    wt::ShortStack st = hs.fresh();
    const wt::Hit h = trace(r, st);
    hs.spills += st.spills;
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  *spills = hs.spills;
}

}  // namespace

extern "C" int wt_host_short_stack() { return kShortStack; }

// K1 (`arity` 4) or K2 (2) over every ray, on the node records `node` of
// that arity, each walk bounded by `t_max` (kBig: unbounded); `spills`
// receives the entries the short stack moved to spill. Non-null `u_out`,
// `v_out`, `n_out` run K1's carrying walk (arity 4, nearest hit, t_max =
// kBig only; 1 otherwise), as wt_launch does.
extern "C" int wt_trace_host(int arity, const float* node, const float* tri_rec,
                             const float* inst_tab, const int32_t* inst_root, int num_instances,
                             const float* origin, int origin_stride, const float* dirs,
                             int64_t num_rays, int occlusion, float* t_out, int32_t* tri_out,
                             int32_t* inst_out, float* u_out, float* v_out, float* n_out,
                             float t_max, int64_t* spills) {
  if (arity != 4 && arity != 2) return 1;
  const wt::CarryOut carry{u_out, v_out, n_out};
  if (carry.any() && (arity != 4 || occlusion || t_max != wt::kBig)) return 1;
  const wt::Scene s{node, tri_rec, inst_tab, inst_root, num_instances};
  trace_all(num_rays, t_out, tri_out, inst_out, spills, [&](int64_t r, wt::ShortStack& st) {
    const float* wo = origin + r * origin_stride;
    const float* wd = dirs + 3 * r;
    if (carry.any()) {
      wt::Carry c;
      const wt::Hit h = wt::trace_ray<4, false, true>(s, wo, wd, st, wt::kBig, &c);
      carry.store(r, c);
      return h;
    }
    if (arity == 2) {
      return occlusion ? wt::trace_ray<2, true>(s, wo, wd, st, t_max)
                       : wt::trace_ray<2, false>(s, wo, wd, st, t_max);
    }
    return occlusion ? wt::trace_ray<4, true>(s, wo, wd, st, t_max)
                     : wt::trace_ray<4, false>(s, wo, wd, st, t_max);
  });
  return 0;
}

extern "C" int tlas_trace_host(const float* wnode, const float* tri_rec, const float* inst_tab,
                               const int32_t* inst_root, int num_instances,
                               const int32_t* tlas_code, const float* tlas_box,
                               const int32_t* tlas_inst_ids, const float* origin,
                               int origin_stride, const float* dirs, int64_t num_rays,
                               int occlusion, float* t_out, int32_t* tri_out,
                               int32_t* inst_out, float* u_out, float* v_out, float* n_out,
                               int64_t* spills) {
  const wt::CarryOut carry{u_out, v_out, n_out};
  if (carry.any() && occlusion) return 1;
  const wt::Scene s{wnode, tri_rec, inst_tab, inst_root, num_instances};
  const wt::Tlas tl{tlas_code, tlas_box, tlas_inst_ids};
  trace_all(num_rays, t_out, tri_out, inst_out, spills, [&](int64_t r, wt::ShortStack& st) {
    const float* wo = origin + r * origin_stride;
    if (carry.any()) {
      wt::Carry c;
      const wt::Hit h = wt::trace_ray_tlas4<false, true>(s, tl, wo, dirs + 3 * r, st, &c);
      carry.store(r, c);
      return h;
    }
    return occlusion ? wt::trace_ray_tlas4<true>(s, tl, wo, dirs + 3 * r, st)
                     : wt::trace_ray_tlas4<false>(s, tl, wo, dirs + 3 * r, st);
  });
  return 0;
}

// The order walk.cuh's sorting network at `arity` (2 or 4) gives `n`
// vectors of `arity` entry distances: order[arity * v + p] is the child of
// rank p.
extern "C" int wt_sort_host(int arity, const float* dist, int64_t n, int32_t* order) {
  if (arity != 4 && arity != 2) return 1;
  for (int64_t v = 0; v < n; ++v) {
    float d[4];
    int idx[4] = {0, 1, 2, 3};
    int32_t code[4] = {0, 1, 2, 3};
    for (int c = 0; c < arity; ++c) d[c] = dist[arity * v + c];
    if (arity == 2) {
      wt::sort_children<2>(d, idx, code);
    } else {
      wt::sort_children<4>(d, idx, code);
    }
    for (int p = 0; p < arity; ++p) order[arity * v + p] = idx[p];
  }
  return 0;
}

// K4 (`arity` 4) or K5 (2) over every ray, on the pages' node records of
// that arity; `spills` receives the entries the short stack moved to
// spill.
extern "C" int paged_trace_host(int arity, const float* node, const int32_t* node_base,
                                const int32_t* tri0, const float* tri_rec, const float* inst_tab,
                                int num_instances, const int32_t* top_code, const float* top_box,
                                const int32_t* top_root, const float* origin, int origin_stride,
                                const float* dirs, int64_t num_rays, float* t_out,
                                int32_t* tri_out, int32_t* inst_out, int64_t* spills) {
  if (arity != 4 && arity != 2) return 1;
  const wt::Pages pg{node, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::TopTree top{top_code, top_box, top_root};
  trace_all(num_rays, t_out, tri_out, inst_out, spills, [&](int64_t r, wt::ShortStack& st) {
    const float* wo = origin + r * origin_stride;
    return arity == 4 ? wt::trace_ray_paged<4>(pg, top, wo, dirs + 3 * r, st)
                      : wt::trace_ray_paged<2>(pg, top, wo, dirs + 3 * r, st);
  });
  return 0;
}

// K6 over every ray (in tile order) with a plan's item order and per-tile
// lists; `spills` as paged_trace_host's.
extern "C" int paged_major_trace_host(int arity, const float* node, const int32_t* node_base,
                                      const int32_t* tri0, const float* tri_rec,
                                      const float* inst_tab, int num_instances,
                                      const int32_t* item_pid, const int32_t* item_iid,
                                      const int32_t* tile_start, const int32_t* tile_item,
                                      int num_tiles, const float* origin, int origin_stride,
                                      const float* dirs, int64_t num_rays, float* t_out,
                                      int32_t* tri_out, int32_t* inst_out, int64_t* spills) {
  if (arity != 4 || (num_rays + wt::kTileRays - 1) / wt::kTileRays != num_tiles) return 1;
  const wt::Pages pg{node, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::Plan plan{item_pid, item_iid, tile_start, tile_item};
  trace_all(num_rays, t_out, tri_out, inst_out, spills, [&](int64_t r, wt::ShortStack& st) {
    return wt::trace_ray_page_major(pg, plan, r / wt::kTileRays, origin + r * origin_stride,
                                    dirs + 3 * r, st);
  });
  return 0;
}

// K6's plan (page_plan_launch's arguments, no stream): the tiles' bounds
// and item tests, the keys, the ranks, the list starts and the lists,
// each from page_plan.cuh's functions, tile by tile and item by item.
extern "C" int page_plan_host(const float* origin, int origin_stride, const float* dirs,
                              int64_t num_rays, const float* inst_tab, const int32_t* inst_mesh,
                              int num_instances, const float* node_min, const float* node_max,
                              const int32_t* page_node0, int num_pages, const int32_t* mesh_root,
                              int num_meshes, uint8_t* wanted, int32_t* tile_count, float* key,
                              int32_t* item_pid, int32_t* item_iid, int32_t* tile_start,
                              int32_t* tile_item) {
  const wt::PlanInput in{origin,   origin_stride, dirs,       num_rays,  inst_tab,
                         inst_mesh, num_instances, node_min,   node_max,  page_node0,
                         num_pages, mesh_root,     num_meshes};
  const int32_t items = in.num_items();
  const int64_t tiles = in.num_tiles();
  if (items <= 0 || num_rays < 0) return 1;
  for (int32_t k = 0; k < items; ++k) key[k] = INFINITY;
  for (int64_t t = 0; t < tiles; ++t) {
    tile_count[t] = 0;
    for (int i = 0; i < num_instances; ++i) {
      wt::TileBounds b;
      for (int slot = 0; slot < wt::kTileRays; ++slot) {
        float wo[3], wd[3], o[3], d[3], inv[3], v[6];
        in.ray(t, slot, wo, wd);
        wt::object_ray(inst_tab + 12 * i, wo, wd, o, d, inv);
        wt::bounds_values(o, inv, v);
        for (int q = 0; q < 6; ++q) {
          b.lo[q] = slot == 0 ? v[q] : fminf(b.lo[q], v[q]);
          b.hi[q] = slot == 0 ? v[q] : fmaxf(b.hi[q], v[q]);
        }
      }
      wt::bounds_widen(b);
      for (int32_t p = 0; p < num_pages; ++p) {
        const int32_t k = i * num_pages + p;
        float near_lo;
        const bool want = in.test(b, k, &near_lo);
        wanted[t * items + k] = want ? 1 : 0;
        if (want) {
          key[k] = fminf(key[k], near_lo);
          ++tile_count[t];
        }
      }
    }
  }
  for (int32_t k = 0; k < items; ++k) {
    const int32_t r = wt::item_rank(key, items, k);
    item_pid[r] = k % num_pages;
    item_iid[r] = k / num_pages;
  }
  tile_start[0] = 0;
  for (int64_t t = 0; t < tiles; ++t) tile_start[t + 1] = tile_start[t] + tile_count[t];
  for (int64_t t = 0; t < tiles; ++t) {
    int32_t next = tile_start[t];
    for (int32_t j = 0; j < items; ++j) {
      if (wanted[t * items + item_iid[j] * num_pages + item_pid[j]]) tile_item[next++] = j;
    }
  }
  return 0;
}
