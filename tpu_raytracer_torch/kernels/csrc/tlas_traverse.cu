// CUDA entry point of kernel K3: the TLAS and the reached instances'
// 4-wide BLAS, with K1's walk (walk.cuh) and launch (walk_launch.cuh).
//
// Replaces tpu_raytracer/kernels/tlas.py:_tlas_kernel (the pallas_call of
// tlas.py:_run_tlas), nearest or any hit; the traversal itself and the
// note on what bounds it live in tlas_traverse.cuh. Built into one
// library with K1 (see wide_traverse.cu and kernels/build.py).
#include <cuda_runtime.h>

#include "tlas_traverse.cuh"
#include "walk_launch.cuh"

namespace {

template <bool kAnyHit>
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK3MinBlocks)
tlas_traverse_kernel(wt::Scene s, wt::Tlas tl, wt::Rays rays, int ring_mask,
                     unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray_tlas4<kAnyHit>(s, tl, wo, wd, st));
  });
}

// K3 with the carry (walk.cuh Carry), nearest hit only, under its own
// name: replaces tlas.py:_tlas_kernel with make_test_tri's carry_uv and
// carry_n (tpu_raytracer/kernels/traversal.py:145).
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK3MinBlocks)
tlas_traverse_carry_kernel(wt::Scene s, wt::Tlas tl, wt::Rays rays, wt::CarryOut out,
                           int ring_mask, unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    wt::Carry c;
    rays.store(r, wt::trace_ray_tlas4<false, true>(s, tl, wo, wd, st, &c));
    out.store(r, c);
  });
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). Arguments as wt_launch's for K1 (the carried outputs
// included: any non-null one launches the carrying kernel, nearest hit
// only), plus the TLAS tables.
extern "C" int tlas_launch(const float* wnode, const float* tri_rec, const float* inst_tab,
                           const int32_t* inst_root, int num_instances,
                           const int32_t* tlas_code, const float* tlas_box,
                           const int32_t* tlas_inst_ids,
                           const float* origin, int origin_stride, const float* dirs,
                           int64_t num_rays, int occlusion, float* t_out,
                           int32_t* tri_out, int32_t* inst_out, float* u_out, float* v_out,
                           float* n_out, int short_stack, unsigned long long* counter,
                           void* stream) {
  const wt::CarryOut carry{u_out, v_out, n_out};
  if (carry.any() && occlusion) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Scene s{wnode, tri_rec, inst_tab, inst_root, num_instances};
  const wt::Tlas tl{tlas_code, tlas_box, tlas_inst_ids};
  const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (carry.any()) {
    return wt::launch_walk(tlas_traverse_carry_kernel, num_rays, short_stack, counter, st, s,
                           tl, rays, carry);
  }
  return occlusion ? wt::launch_walk(tlas_traverse_kernel<true>, num_rays, short_stack,
                                     counter, st, s, tl, rays)
                   : wt::launch_walk(tlas_traverse_kernel<false>, num_rays, short_stack,
                                     counter, st, s, tl, rays);
}

// K3's launch for `num_rays` rays (walk_shape); `occlusion` 2 is the
// carrying kernel.
extern "C" int tlas_launch_shape(int occlusion, int short_stack, int64_t num_rays, int* out) {
  if (occlusion == 2) {
    return wt::walk_shape(tlas_traverse_carry_kernel, short_stack, num_rays, out);
  }
  return occlusion ? wt::walk_shape(tlas_traverse_kernel<true>, short_stack, num_rays, out)
                   : wt::walk_shape(tlas_traverse_kernel<false>, short_stack, num_rays, out);
}
