// CUDA entry point of kernel K6: page-major paged traversal. One block
// per tile of wt::kTileRays consecutive rays (the wrapper orders an
// image's rays in 16x16-pixel tiles); each thread walks, in the host
// plan's front-to-back order, the (instance, page) items its tile may
// see, with its best hit in registers.
//
// Replaces tpu_raytracer/kernels/paged_major.py:_page_major_kernel; the
// traversal and the note on what bounds it live in paged_traverse.cuh.
// Built with the other kernels into one library (kernels/build.py),
// plain C interface bound with ctypes.
#include <cuda_runtime.h>

#include "paged_traverse.cuh"

namespace {

__global__ void __launch_bounds__(wt::kTileRays)
paged_major_kernel(wt::Pages pg, wt::Plan plan, const float* __restrict__ origin,
                   int origin_stride, const float* __restrict__ dirs, int64_t num_rays,
                   float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                   int32_t* __restrict__ inst_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * wt::kTileRays + threadIdx.x;
  if (r >= num_rays) return;
  const float wo[3] = {origin[r * origin_stride + 0],
                       origin[r * origin_stride + 1],
                       origin[r * origin_stride + 2]};
  const float wd[3] = {dirs[3 * r + 0], dirs[3 * r + 1], dirs[3 * r + 2]};
  const wt::Hit h = wt::trace_ray_page_major(pg, plan, blockIdx.x, wo, wd);
  t_out[r] = h.t;
  tri_out[r] = h.tri;
  inst_out[r] = h.inst;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue unless arity is 4 and num_tiles is
// ceil(num_rays / kTileRays).
extern "C" int paged_major_launch(int arity, const int32_t* code, const float* box,
                                  const int32_t* node_base, const int32_t* tri0,
                                  const float* tri_rec, const float* inst_tab,
                                  int num_instances, const int32_t* item_pid,
                                  const int32_t* item_iid, int num_items,
                                  const uint8_t* mask, int num_tiles,
                                  const float* origin, int origin_stride,
                                  const float* dirs, int64_t num_rays, float* t_out,
                                  int32_t* tri_out, int32_t* inst_out, void* stream) {
  const int64_t tiles = (num_rays + wt::kTileRays - 1) / wt::kTileRays;
  if (arity != 4 || tiles != num_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return 0;
  const wt::Pages pg{code, box, node_base, tri0, tri_rec, inst_tab, num_instances};
  const wt::Plan plan{item_pid, item_iid, num_items, mask, num_tiles};
  paged_major_kernel<<<static_cast<unsigned>(tiles), wt::kTileRays, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pg, plan, origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}
