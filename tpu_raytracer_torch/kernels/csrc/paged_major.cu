// CUDA entry point of kernel K6: page-major paged traversal. Each thread
// walks, in plan order, the (instance, page) items that the plan
// (page_plan.cu) lists for its ray's tile of wt::kTileRays consecutive
// rays (the wrapper orders an image's rays in 16x16-pixel tiles), each
// page with the walk of walk.cuh at arity 4 over the pages' node records,
// on the short stack, its best hit in registers. One block of kTileRays
// threads per tile, so that a block's threads share one item list: it
// measured 11% faster than persistent warps on the colonnade (PERF.md
// section 6), though a warp's rays would stay inside one tile there too.
//
// Replaces tpu_raytracer/kernels/paged_major.py:_page_major_kernel; the
// traversal and the note on what bounds it live in paged_traverse.cuh.
// Built with the other kernels into one library (kernels/build.py),
// plain C interface bound with ctypes.
#include <cuda_runtime.h>

#include "paged_traverse.cuh"
#include "walk_launch.cuh"

namespace {

__global__ void __launch_bounds__(wt::kTileRays)
paged_major_kernel(wt::Pages pg, wt::Plan plan, wt::Rays rays, int ring_mask,
                   unsigned long long* counter) {
  extern __shared__ int32_t ring[];
  int32_t spill[wt::kStack];
  const auto trace = [&](int64_t r) {
    float wo[3], wd[3];
    rays.load(r, wo, wd);
    wt::ShortStack st(ring + threadIdx.x, blockDim.x, ring_mask, spill);
    rays.store(r, wt::trace_ray_page_major(pg, plan, r / wt::kTileRays, wo, wd, st));
  };
  const int64_t r = static_cast<int64_t>(blockIdx.x) * wt::kTileRays + threadIdx.x;
  if (r < rays.num_rays) trace(r);
}

// The one-block-per-tile launch for `num_rays` rays: out = {blocks,
// threads, dynamic shared bytes, resident blocks per SM}.
int tile_shape(int short_stack, int64_t num_rays, int* out) {
  if (short_stack < 1 || short_stack > wt::kMaxShortStack || (short_stack & (short_stack - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = short_stack * wt::kTileRays * static_cast<int>(sizeof(int32_t));
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared memory
    err = cudaFuncSetAttribute(paged_major_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_major_kernel,
                                                        wt::kTileRays, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>((num_rays + wt::kTileRays - 1) / wt::kTileRays);
  out[1] = wt::kTileRays;
  out[2] = smem;
  out[3] = per_sm;
  return 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue unless arity is 4, num_tiles is
// ceil(num_rays / kTileRays) and the short stack is valid. The plan's
// arrays are page_plan_launch's outputs. `counter` may be null: only the
// A/B script's variant with persistent warps (bench_walk.py) counts rays
// on it.
extern "C" int paged_major_launch(int arity, const float* node, const int32_t* node_base,
                                  const int32_t* tri0, const float* tri_rec,
                                  const float* inst_tab, int num_instances,
                                  const int32_t* item_pid, const int32_t* item_iid,
                                  const int32_t* tile_start, const int32_t* tile_item,
                                  int num_tiles, const float* origin, int origin_stride,
                                  const float* dirs, int64_t num_rays, float* t_out,
                                  int32_t* tri_out, int32_t* inst_out, int short_stack,
                                  unsigned long long* counter, void* stream) {
  const int64_t tiles = (num_rays + wt::kTileRays - 1) / wt::kTileRays;
  if (arity != 4 || tiles != num_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Pages pg{node, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::Plan plan{item_pid, item_iid, tile_start, tile_item};
  const wt::Rays rays{origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int shape[4];
  const int err = tile_shape(short_stack, num_rays, shape);
  if (err != 0) return err;
  paged_major_kernel<<<shape[0], shape[1], shape[2], st>>>(pg, plan, rays, short_stack - 1,
                                                           counter);
  return static_cast<int>(cudaGetLastError());
}

// K6's launch for `num_rays` rays.
extern "C" int paged_major_launch_shape(int short_stack, int64_t num_rays, int* out) {
  return tile_shape(short_stack, num_rays, out);
}
