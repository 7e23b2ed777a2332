// CUDA entry point of kernels K1 and K2: K1 walks the 4-wide BVH with the
// walk of walk4.cuh, K2 the binary BVH with one thread per ray.
//
// K1 replaces tpu_raytracer/kernels/dual.py:_dual_kernel (the pallas_call
// of dual.py:_run_dual) in wide mode, K2
// tpu_raytracer/kernels/traversal.py:_traversal_kernel (the pallas_call of
// traversal.py:_run_kernel), nearest or any hit. K1's design (node
// records, short stack in shared memory, sorting network, unordered any
// hit, persistent warps) and what bounds it are in walk4.cuh; K2 is
// walk_tree at arity 2 (wide_traverse.cuh), over the whole binary tree
// (kernels/binary.py), under its own kernel name so that a profile tells
// the two apart.
//
// Built together with K3-K6 into one library (kernels/build.py), one nvcc
// per source:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c wide_traverse.cu
// The library has a plain C interface bound with ctypes: no PyTorch
// headers, so it builds in seconds.
#include <cuda_runtime.h>

#include "walk4_launch.cuh"

namespace {

constexpr int kThreads = 128;

template <int kArity, bool kAnyHit>
__device__ __forceinline__ void trace_one(const wt::Scene& s,
                                          const float* __restrict__ origin,
                                          int origin_stride,
                                          const float* __restrict__ dirs,
                                          int64_t num_rays, float* __restrict__ t_out,
                                          int32_t* __restrict__ tri_out,
                                          int32_t* __restrict__ inst_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float wo[3] = {origin[r * origin_stride + 0],
                       origin[r * origin_stride + 1],
                       origin[r * origin_stride + 2]};
  const float wd[3] = {dirs[3 * r + 0], dirs[3 * r + 1], dirs[3 * r + 2]};
  const wt::Hit h = wt::trace_ray<kArity>(s, wo, wd, kAnyHit);
  t_out[r] = h.t;
  tri_out[r] = h.tri;
  inst_out[r] = h.inst;
}

// kAnyHit is a template argument so the nearest-hit kernels compile
// without the any-hit branches.
template <bool kAnyHit>
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK1MinBlocks)
wide_traverse_kernel(wt::Scene s, wt::Rays rays, int ring_mask,
                     unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray4<kAnyHit>(s, wo, wd, st));
  });
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
binary_traverse_kernel(wt::Scene s, const float* __restrict__ origin,
                       int origin_stride, const float* __restrict__ dirs,
                       int64_t num_rays, float* __restrict__ t_out,
                       int32_t* __restrict__ tri_out,
                       int32_t* __restrict__ inst_out) {
  trace_one<2, kAnyHit>(s, origin, origin_stride, dirs, num_rays, t_out, tri_out,
                        inst_out);
}

}  // namespace

// Launch K1 (`arity` 4: the node records `wnode`) or K2 (`arity` 2: the
// binary tables `wcode`/`wbox`) on `stream`; returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for any other
// arity or a bad short stack. `origin_stride` is 0 for one origin shared
// by every ray (primary rays) and 3 for per-ray origins [R, 3].
// `occlusion` != 0 selects the any-hit mode. K1 only: `short_stack` is S,
// the ring slots per thread (a power of two, at most kMaxShortStack), and
// `counter` one zeroed u64 for its persistent warps.
extern "C" int wt_launch(int arity, const int32_t* wcode, const float* wbox,
                         const float* tri_rec, const float* inst_tab,
                         const int32_t* inst_root, int num_instances,
                         const float* wnode, const float* origin, int origin_stride,
                         const float* dirs, int64_t num_rays, int occlusion,
                         float* t_out, int32_t* tri_out, int32_t* inst_out,
                         int short_stack, unsigned long long* counter, void* stream) {
  if (arity != 4 && arity != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Scene s{wcode, wbox, tri_rec, inst_tab, inst_root, num_instances, wnode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arity == 4) {
    const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
    return occlusion ? wt::launch_walk4(wide_traverse_kernel<true>, num_rays, short_stack,
                                        counter, st, s, rays)
                     : wt::launch_walk4(wide_traverse_kernel<false>, num_rays, short_stack,
                                        counter, st, s, rays);
  }
  const unsigned blocks =
      static_cast<unsigned>((num_rays + kThreads - 1) / kThreads);
  if (occlusion) {
    binary_traverse_kernel<true><<<blocks, kThreads, 0, st>>>(
        s, origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out);
  } else {
    binary_traverse_kernel<false><<<blocks, kThreads, 0, st>>>(
        s, origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch K1 makes for `num_rays` rays (walk4_shape).
extern "C" int wt_launch_shape(int occlusion, int short_stack, int64_t num_rays, int* out) {
  return occlusion ? wt::walk4_shape(wide_traverse_kernel<true>, short_stack, num_rays, out)
                   : wt::walk4_shape(wide_traverse_kernel<false>, short_stack, num_rays, out);
}
