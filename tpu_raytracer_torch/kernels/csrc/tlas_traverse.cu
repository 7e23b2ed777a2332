// CUDA entry point of kernel K3: one thread per ray through the TLAS and
// the reached instances' 4-wide BLAS.
//
// Replaces tpu_raytracer/kernels/tlas.py:_tlas_kernel (the pallas_call of
// tlas.py:_run_tlas), nearest or any hit; the traversal itself and the
// note on what bounds it live in tlas_traverse.cuh. Built into one
// library with K1 (see wide_traverse.cu and kernels/build.py).
#include <cuda_runtime.h>

#include "tlas_traverse.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
tlas_traverse_kernel(wt::Scene s, wt::Tlas tl,
                     const float* __restrict__ origin, int origin_stride,
                     const float* __restrict__ dirs, int64_t num_rays,
                     float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                     int32_t* __restrict__ inst_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float wo[3] = {origin[r * origin_stride + 0],
                       origin[r * origin_stride + 1],
                       origin[r * origin_stride + 2]};
  const float wd[3] = {dirs[3 * r + 0], dirs[3 * r + 1], dirs[3 * r + 2]};
  const wt::Hit h = wt::trace_ray_tlas(s, tl, wo, wd, kAnyHit);
  t_out[r] = h.t;
  tri_out[r] = h.tri;
  inst_out[r] = h.inst;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). Arguments as wt_launch, plus the TLAS tables.
extern "C" int tlas_launch(const int32_t* wcode, const float* wbox,
                           const float* tri_rec, const float* inst_tab,
                           const int32_t* inst_root, int num_instances,
                           const int32_t* tlas_code, const float* tlas_box,
                           const int32_t* tlas_inst_ids, const float* origin,
                           int origin_stride, const float* dirs,
                           int64_t num_rays, int occlusion, float* t_out,
                           int32_t* tri_out, int32_t* inst_out, void* stream) {
  if (num_rays <= 0) return 0;
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  const wt::Tlas tl{tlas_code, tlas_box, tlas_inst_ids};
  const unsigned blocks =
      static_cast<unsigned>((num_rays + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (occlusion) {
    tlas_traverse_kernel<true><<<blocks, kThreads, 0, st>>>(
        s, tl, origin, origin_stride, dirs, num_rays, t_out, tri_out,
        inst_out);
  } else {
    tlas_traverse_kernel<false><<<blocks, kThreads, 0, st>>>(
        s, tl, origin, origin_stride, dirs, num_rays, t_out, tri_out,
        inst_out);
  }
  return static_cast<int>(cudaGetLastError());
}
