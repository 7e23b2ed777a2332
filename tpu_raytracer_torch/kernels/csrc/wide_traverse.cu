// CUDA entry point of kernel K1: one thread per ray over the 4-wide BVH.
//
// Replaces tpu_raytracer/kernels/dual.py:_dual_kernel (the pallas_call of
// dual.py:_run_dual) in wide mode, nearest or any hit; the traversal
// itself and the note on what bounds it live in wide_traverse.cuh.
//
// Built together with K3 (tlas_traverse.cu) into one library
// (kernels/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libtraverse.so wide_traverse.cu
//        tlas_traverse.cu
// The library has a plain C interface bound with ctypes: no PyTorch
// headers, so it builds in seconds.
#include <cuda_runtime.h>

#include "wide_traverse.cuh"

namespace {

constexpr int kThreads = 128;

// kAnyHit is a template argument so the nearest-hit kernel compiles
// without the any-hit branches.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
wide_traverse_kernel(wt::Scene s, const float* __restrict__ origin,
                     int origin_stride, const float* __restrict__ dirs,
                     int64_t num_rays, float* __restrict__ t_out,
                     int32_t* __restrict__ tri_out,
                     int32_t* __restrict__ inst_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float wo[3] = {origin[r * origin_stride + 0],
                       origin[r * origin_stride + 1],
                       origin[r * origin_stride + 2]};
  const float wd[3] = {dirs[3 * r + 0], dirs[3 * r + 1], dirs[3 * r + 2]};
  const wt::Hit h = wt::trace_ray(s, wo, wd, kAnyHit);
  t_out[r] = h.t;
  tri_out[r] = h.tri;
  inst_out[r] = h.inst;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). `origin_stride` is 0 for one origin shared by every ray
// (primary rays) and 3 for per-ray origins [R, 3]. `occlusion` != 0
// selects the any-hit mode.
extern "C" int wt_launch(const int32_t* wcode, const float* wbox,
                         const float* tri_rec, const float* inst_tab,
                         const int32_t* inst_root, int num_instances,
                         const float* origin, int origin_stride,
                         const float* dirs, int64_t num_rays, int occlusion,
                         float* t_out, int32_t* tri_out, int32_t* inst_out,
                         void* stream) {
  if (num_rays <= 0) return 0;
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances};
  const unsigned blocks =
      static_cast<unsigned>((num_rays + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (occlusion) {
    wide_traverse_kernel<true><<<blocks, kThreads, 0, st>>>(
        s, origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out);
  } else {
    wide_traverse_kernel<false><<<blocks, kThreads, 0, st>>>(
        s, origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out);
  }
  return static_cast<int>(cudaGetLastError());
}
