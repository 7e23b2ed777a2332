// Host builds of the traversal headers for the CPU tests: the same
// per-ray code the CUDA kernels K1 (wide_traverse.cuh) and K3
// (tlas_traverse.cuh) run, looped over rays.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -o libtraverse_host.so traverse_host.cpp
#include "tlas_traverse.cuh"

extern "C" int wt_trace_host(const int32_t* wcode, const float* wbox,
                             const float* tri_rec, const float* inst_tab,
                             const int32_t* inst_root, int num_instances,
                             const float* origin, int origin_stride,
                             const float* dirs, int64_t num_rays,
                             int occlusion, float* t_out, int32_t* tri_out,
                             int32_t* inst_out) {
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  for (int64_t r = 0; r < num_rays; ++r) {
    const wt::Hit h = wt::trace_ray(s, origin + r * origin_stride,
                                    dirs + 3 * r, occlusion != 0);
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
