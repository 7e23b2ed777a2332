// Host builds of the traversal headers for the CPU tests: the same
// per-ray code the CUDA kernels K1 and K2 (wide_traverse.cuh), K3
// (tlas_traverse.cuh) and K4-K6 (paged_traverse.cuh) run, looped over
// rays.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -o libtraverse_host.so traverse_host.cpp
#include "paged_traverse.cuh"
#include "tlas_traverse.cuh"

extern "C" int wt_trace_host(int arity, const int32_t* wcode, const float* wbox,
                             const float* tri_rec, const float* inst_tab,
                             const int32_t* inst_root, int num_instances,
                             const float* origin, int origin_stride,
                             const float* dirs, int64_t num_rays,
                             int occlusion, float* t_out, int32_t* tri_out,
                             int32_t* inst_out) {
  if (arity != 4 && arity != 2) return 1;
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  for (int64_t r = 0; r < num_rays; ++r) {
    const float* wo = origin + r * origin_stride;
    const wt::Hit h = arity == 4 ? wt::trace_ray<4>(s, wo, dirs + 3 * r, occlusion != 0)
                                 : wt::trace_ray<2>(s, wo, dirs + 3 * r, occlusion != 0);
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  return 0;
}

extern "C" int tlas_trace_host(const int32_t* wcode, const float* wbox,
                               const float* tri_rec, const float* inst_tab,
                               const int32_t* inst_root, int num_instances,
                               const int32_t* tlas_code, const float* tlas_box,
                               const int32_t* tlas_inst_ids,
                               const float* origin, int origin_stride,
                               const float* dirs, int64_t num_rays,
                               int occlusion, float* t_out, int32_t* tri_out,
                               int32_t* inst_out) {
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  const wt::Tlas tl{tlas_code, tlas_box, tlas_inst_ids};
  for (int64_t r = 0; r < num_rays; ++r) {
    const wt::Hit h = wt::trace_ray_tlas(s, tl, origin + r * origin_stride,
                                         dirs + 3 * r, occlusion != 0);
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  return 0;
}

extern "C" int paged_trace_host(int arity, const int32_t* code, const float* box,
                                const int32_t* node_base, const int32_t* tri0,
                                const float* tri_rec, const float* inst_tab,
                                int num_instances, const int32_t* top_code,
                                const float* top_box, const int32_t* top_root,
                                const float* origin, int origin_stride,
                                const float* dirs, int64_t num_rays, float* t_out,
                                int32_t* tri_out, int32_t* inst_out) {
  if (arity != 4 && arity != 2) return 1;
  const wt::Pages pg{code, box, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::TopTree top{top_code, top_box, top_root};
  for (int64_t r = 0; r < num_rays; ++r) {
    const float* wo = origin + r * origin_stride;
    const wt::Hit h = arity == 4 ? wt::trace_ray_paged<4>(pg, top, wo, dirs + 3 * r)
                                 : wt::trace_ray_paged<2>(pg, top, wo, dirs + 3 * r);
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  return 0;
}

extern "C" int paged_major_trace_host(int arity, const int32_t* code, const float* box,
                                      const int32_t* node_base, const int32_t* tri0,
                                      const float* tri_rec, const float* inst_tab,
                                      int num_instances, const int32_t* item_pid,
                                      const int32_t* item_iid, int num_items,
                                      const uint8_t* mask, int num_tiles,
                                      const float* origin, int origin_stride,
                                      const float* dirs, int64_t num_rays, float* t_out,
                                      int32_t* tri_out, int32_t* inst_out) {
  if (arity != 4 || (num_rays + wt::kTileRays - 1) / wt::kTileRays != num_tiles) return 1;
  const wt::Pages pg{code, box, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::Plan plan{item_pid, item_iid, num_items, mask, num_tiles};
  for (int64_t r = 0; r < num_rays; ++r) {
    const wt::Hit h = wt::trace_ray_page_major(pg, plan, static_cast<int>(r / wt::kTileRays),
                                               origin + r * origin_stride, dirs + 3 * r);
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  return 0;
}
