// Host build of kernel K1's traversal (wide_traverse.cuh) for the CPU
// tests: the same per-ray code the CUDA kernel runs, looped over rays.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -o libwide_traverse_host.so wide_traverse_host.cpp
#include "wide_traverse.cuh"

extern "C" int wt_trace_host(const int32_t* wcode, const float* wbox,
                             const float* tri_rec, const float* inst_tab,
                             const int32_t* inst_root, int num_instances,
                             const float* origin, int origin_stride,
                             const float* dirs, int64_t num_rays,
                             float* t_out, int32_t* tri_out,
                             int32_t* inst_out) {
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  for (int64_t r = 0; r < num_rays; ++r) {
    const wt::Hit h = wt::trace_ray(s, origin + r * origin_stride, dirs + 3 * r);
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
  return 0;
}
