// CUDA entry point of kernels K1 and K2: K1 walks the 4-wide BVH, K2 the
// binary BVH, both with the walk of walk.cuh.
//
// K1 replaces tpu_raytracer/kernels/dual.py:_dual_kernel (the pallas_call
// of dual.py:_run_dual) in wide mode, K2
// tpu_raytracer/kernels/traversal.py:_traversal_kernel (the pallas_call of
// traversal.py:_run_kernel), nearest or any hit. Their design (node
// records, short stack in shared memory, sorting network, unordered any
// hit, persistent warps) and what bounds them are in walk.cuh; K2 is its
// arity-2 case over every mesh's whole binary tree (kernels/binary.py),
// under its own kernel name so that a profile tells the two apart.
//
// Built together with K3-K6 into one library (kernels/build.py), one nvcc
// per source:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c wide_traverse.cu
// The library has a plain C interface bound with ctypes: no PyTorch
// headers, so it builds in seconds.
#include <cuda_runtime.h>

#include "walk_launch.cuh"

namespace {

// One ray of K1 or K2 per call of for_each_ray's body, its walk bounded by
// t_max (walk.cuh trace_ray).
template <int kArity, bool kAnyHit>
__device__ __forceinline__ void trace_rays(const wt::Scene& s, const wt::Rays& rays, float t_max,
                                           int ring_mask, unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray<kArity, kAnyHit>(s, wo, wd, st, t_max));
  });
}

// kAnyHit is a template argument so the nearest-hit kernels compile
// without the any-hit branches.
template <bool kAnyHit>
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK1MinBlocks)
wide_traverse_kernel(wt::Scene s, wt::Rays rays, float t_max, int ring_mask,
                     unsigned long long* counter) {
  trace_rays<4, kAnyHit>(s, rays, t_max, ring_mask, counter);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK2MinBlocks)
binary_traverse_kernel(wt::Scene s, wt::Rays rays, float t_max, int ring_mask,
                       unsigned long long* counter) {
  trace_rays<2, kAnyHit>(s, rays, t_max, ring_mask, counter);
}

// K1 with the carry (walk.cuh Carry): nearest hit only, unbounded, its
// own name so that the kernels without it keep their code and a profile
// tells them apart. Replaces dual.py:_dual_kernel with make_test_tri's
// carry_uv and carry_n (tpu_raytracer/kernels/traversal.py:145).
__global__ void __launch_bounds__(wt::kWalkThreads, wt::kK1MinBlocks)
wide_traverse_carry_kernel(wt::Scene s, wt::Rays rays, wt::CarryOut out, int ring_mask,
                           unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  wt::for_each_ray(rays.num_rays, counter, [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    wt::Carry c;
    rays.store(r, wt::trace_ray<4, false, true>(s, wo, wd, st, wt::kBig, &c));
    out.store(r, c);
  });
}

template <bool kAnyHit>
int launch(int arity, int64_t num_rays, int short_stack, unsigned long long* counter,
           cudaStream_t st, const wt::Scene& s, const wt::Rays& rays, float t_max) {
  return arity == 4 ? wt::launch_walk(wide_traverse_kernel<kAnyHit>, num_rays, short_stack,
                                      counter, st, s, rays, t_max)
                    : wt::launch_walk(binary_traverse_kernel<kAnyHit>, num_rays, short_stack,
                                      counter, st, s, rays, t_max);
}

}  // namespace

// Launch K1 (`arity` 4: `node` is the 4-wide records `wnode`) or K2
// (`arity` 2: the binary records) on `stream`; returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for any other
// arity or a bad short stack. `origin_stride` is 0 for one origin shared
// by every ray (primary rays) and 3 for per-ray origins [R, 3].
// `occlusion` != 0 selects the any-hit mode. `t_max` bounds the walk
// (walk.cuh trace_ray): only hits nearer than it are found, the rest are
// misses; kBig for the unbounded walk. `short_stack` is S, the ring slots
// per thread (a power of two, at most kMaxShortStack), and `counter` one
// zeroed u64 for the persistent warps. `u_out`, `v_out` ([R]) and `n_out`
// ([R, 3]) are the carried fields (walk.cuh Carry); any non-null one
// launches K1's carrying kernel, which takes arity 4, nearest hit and
// t_max = kBig only (cudaErrorInvalidValue otherwise); null ones are not
// written.
extern "C" int wt_launch(int arity, const float* node, const float* tri_rec,
                         const float* inst_tab, const int32_t* inst_root, int num_instances,
                         const float* origin, int origin_stride, const float* dirs,
                         int64_t num_rays, int occlusion, float* t_out, int32_t* tri_out,
                         int32_t* inst_out, float* u_out, float* v_out, float* n_out,
                         float t_max, int short_stack, unsigned long long* counter,
                         void* stream) {
  if (arity != 4 && arity != 2) return static_cast<int>(cudaErrorInvalidValue);
  const wt::CarryOut carry{u_out, v_out, n_out};
  if (carry.any() && (arity != 4 || occlusion || t_max != wt::kBig)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rays <= 0) return 0;
  const wt::Scene s{node, tri_rec, inst_tab, inst_root, num_instances};
  const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (carry.any()) {
    return wt::launch_walk(wide_traverse_carry_kernel, num_rays, short_stack, counter, st, s,
                           rays, carry);
  }
  return occlusion ? launch<true>(arity, num_rays, short_stack, counter, st, s, rays, t_max)
                   : launch<false>(arity, num_rays, short_stack, counter, st, s, rays, t_max);
}

// The launch K1 (`arity` 4) or K2 (2) makes for `num_rays` rays
// (walk_shape); `occlusion` 2 is K1's carrying kernel.
extern "C" int wt_launch_shape(int arity, int occlusion, int short_stack, int64_t num_rays,
                               int* out) {
  if (arity == 4 && occlusion == 2) {
    return wt::walk_shape(wide_traverse_carry_kernel, short_stack, num_rays, out);
  }
  if (arity == 4) {
    return occlusion ? wt::walk_shape(wide_traverse_kernel<true>, short_stack, num_rays, out)
                     : wt::walk_shape(wide_traverse_kernel<false>, short_stack, num_rays, out);
  }
  if (arity == 2) {
    return occlusion ? wt::walk_shape(binary_traverse_kernel<true>, short_stack, num_rays, out)
                     : wt::walk_shape(binary_traverse_kernel<false>, short_stack, num_rays, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
