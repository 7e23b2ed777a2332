// CUDA entry point of kernels K4 and K5: one thread per ray through the
// top tree and the pages of a paged scene. K4 walks 4-wide pages with the
// walk of walk.cuh on persistent warps (paged_wide_kernel); K5 walks
// binary pages with walk_tree<2>, one thread per ray of the grid
// (paged_kernel<2>).
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

constexpr int kThreads = 128;

template <int kArity>
__global__ void __launch_bounds__(kThreads)
paged_kernel(wt::Pages pg, wt::TopTree top, const float* __restrict__ origin,
             int origin_stride, const float* __restrict__ dirs, int64_t num_rays,
             float* __restrict__ t_out, int32_t* __restrict__ tri_out,
             int32_t* __restrict__ inst_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float wo[3] = {origin[r * origin_stride + 0],
                       origin[r * origin_stride + 1],
                       origin[r * origin_stride + 2]};
  const float wd[3] = {dirs[3 * r + 0], dirs[3 * r + 1], dirs[3 * r + 2]};
  const wt::Hit h = wt::trace_ray_paged<kArity>(pg, top, wo, wd);
  t_out[r] = h.t;
  tri_out[r] = h.tri;
  inst_out[r] = h.inst;
}

__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK4MinBlocks)
paged_wide_kernel(wt::Pages pg, const float* __restrict__ node, wt::TopTree top,
                  wt::Rays rays, int ring_mask, unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray_paged4(pg, node, top, wo, wd, st));
  });
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for an arity other than 4 or 2 or a
// bad short stack. `origin_stride` is 0 for one origin shared by every
// ray, 3 for per-ray origins [R, 3]. K4 (`arity` 4) only: `node` is the
// pages' node records [N, 32], `short_stack` the ring slots per thread (a
// power of two, at most kMaxShortStack) and `counter` one zeroed u64 for
// the persistent warps; K5 reads `code`/`box` and ignores the three.
extern "C" int paged_launch(int arity, const int32_t* code, const float* box,
                            const int32_t* node_base, const int32_t* tri0,
                            const float* tri_rec, const float* inst_tab,
                            int num_instances, const int32_t* top_code,
                            const float* top_box, const int32_t* top_root, const float* node,
                            const float* origin, int origin_stride,
                            const float* dirs, int64_t num_rays, float* t_out,
                            int32_t* tri_out, int32_t* inst_out, int short_stack,
                            unsigned long long* counter, void* stream) {
  if (arity != 4 && arity != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Pages pg{code, box, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::TopTree top{top_code, top_box, top_root};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arity == 4) {
    const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
    return wt::launch_walk(paged_wide_kernel, num_rays, short_stack, counter, st, pg, node, top,
                           rays);
  }
  const unsigned blocks = static_cast<unsigned>((num_rays + kThreads - 1) / kThreads);
  paged_kernel<2><<<blocks, kThreads, 0, st>>>(pg, top, origin, origin_stride, dirs, num_rays,
                                               t_out, tri_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}

// K4's launch for `num_rays` rays (walk_shape).
extern "C" int paged_launch_shape(int short_stack, int64_t num_rays, int* out) {
  return wt::walk_shape(paged_wide_kernel, short_stack, num_rays, out);
}
