// CUDA entry point of kernels K4 and K5: one thread per ray on persistent
// warps through the top tree and the pages of a paged scene, with the walk
// of walk.cuh in each page: K4 (paged_wide_kernel) on 4-wide pages, K5
// (paged_binary_kernel) on binary pages. Both run trace_ray_paged<A> of
// paged_traverse.cuh, under kernel names of their own so that a profile
// tells them apart.
//
// Replaces tpu_raytracer/kernels/paged_wide.py:_paged_wide_kernel (K4)
// and tpu_raytracer/kernels/paged.py:_paged_kernel (K5); the traversal
// and the note on what bounds it live in paged_traverse.cuh. Built with
// the other kernels into one library (kernels/build.py), plain C
// interface bound with ctypes.
#include <cuda_runtime.h>

#include "paged_traverse.cuh"
#include "walk_launch.cuh"

namespace {

template <int kArity>
__device__ __forceinline__ void trace_rays(const wt::Pages& pg, const wt::TopTree& top,
                                           const wt::Rays& rays, int ring_mask,
                                           unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray_paged<kArity>(pg, top, wo, wd, st));
  });
}

__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK4MinBlocks)
paged_wide_kernel(wt::Pages pg, wt::TopTree top, wt::Rays rays, int ring_mask,
                  unsigned long long* counter) {
  trace_rays<4>(pg, top, rays, ring_mask, counter);
}

__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK5MinBlocks)
paged_binary_kernel(wt::Pages pg, wt::TopTree top, wt::Rays rays, int ring_mask,
                    unsigned long long* counter) {
  trace_rays<2>(pg, top, rays, ring_mask, counter);
}

}  // namespace

// Launch K4 (`arity` 4: `node` is the 4-wide pages' records [N, 32]) or
// K5 (`arity` 2: the binary pages' records [N, 16]) on `stream`; returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for another arity or a bad short stack.
// `origin_stride` is 0 for one origin shared by every ray, 3 for per-ray
// origins [R, 3]; `short_stack` is the ring slots per thread (a power of
// two, at most kMaxShortStack) and `counter` one zeroed u64 for the
// persistent warps.
extern "C" int paged_launch(int arity, const float* node, const int32_t* node_base,
                            const int32_t* tri0, const float* tri_rec, const float* inst_tab,
                            int num_instances, const int32_t* top_code, const float* top_box,
                            const int32_t* top_root, const float* origin, int origin_stride,
                            const float* dirs, int64_t num_rays, float* t_out,
                            int32_t* tri_out, int32_t* inst_out, int short_stack,
                            unsigned long long* counter, void* stream) {
  if (arity != 4 && arity != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Pages pg{node, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::TopTree top{top_code, top_box, top_root};
  const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return arity == 4
             ? wt::launch_walk(paged_wide_kernel, num_rays, short_stack, counter, st, pg, top, rays)
             : wt::launch_walk(paged_binary_kernel, num_rays, short_stack, counter, st, pg, top,
                               rays);
}

// The launch K4 (`arity` 4) or K5 (2) makes for `num_rays` rays
// (walk_shape).
extern "C" int paged_launch_shape(int arity, int short_stack, int64_t num_rays, int* out) {
  if (arity == 4) return wt::walk_shape(paged_wide_kernel, short_stack, num_rays, out);
  if (arity == 2) return wt::walk_shape(paged_binary_kernel, short_stack, num_rays, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
