// Launch side of the walk.cuh kernels K1 and K2 (wide_traverse.cu), K3
// (tlas_traverse.cu), K4 and K5 (paged_traverse.cu) and K6
// (paged_major.cu): the rays' input and output, the launch shape (block
// size, the short stack's dynamic shared memory, the persistent grid) and
// the launch itself. CUDA only.
#pragma once

#include <cuda_runtime.h>

#include "walk.cuh"

namespace wt {

constexpr int kWalkThreads = 128;   // threads per block
// Resident blocks per SM asked of ptxas (__launch_bounds__). K3 at 8 is
// held to 64 registers, which measured 1-3% faster on config 4's rays
// than no minimum (69-70 registers); K1 takes 64 either way and measured
// 2-4% faster with no minimum (PERF.md section 6).
constexpr int kK1MinBlocks = 1;
constexpr int kK2MinBlocks = 1;
constexpr int kK3MinBlocks = 8;
constexpr int kK4MinBlocks = 1;
constexpr int kK5MinBlocks = 1;
constexpr int kMaxShortStack = 64;  // ring slots per thread: 32 KB of a block at 64

// One cast's rays and hit record. `origin_stride` is 0 for one origin
// shared by every ray and 3 for per-ray origins [R, 3].
struct Rays {
  const float* __restrict__ origin;
  int origin_stride;
  const float* __restrict__ dirs;
  int64_t num_rays;
  float* __restrict__ t_out;
  int32_t* __restrict__ tri_out;
  int32_t* __restrict__ inst_out;

  __device__ __forceinline__ void load(int64_t r, float* wo, float* wd) const {
    for (int k = 0; k < 3; ++k) {
      wo[k] = origin[r * origin_stride + k];
      wd[k] = dirs[3 * r + k];
    }
  }

  __device__ __forceinline__ void store(int64_t r, const Hit& h) const {
    t_out[r] = h.t;
    tri_out[r] = h.tri;
    inst_out[r] = h.inst;
  }
};

// The launch of `kernel` for `num_rays` rays with a ring of `short_stack`
// slots per thread: out = {blocks, threads, dynamic shared bytes, resident
// blocks per SM}. The grid is what the SMs hold at once (persistent
// warps), or less for a small cast. Returns a CUDA error code.
template <class Kernel>
int walk_shape(Kernel kernel, int short_stack, int64_t num_rays, int* out) {
  if (short_stack < 1 || short_stack > kMaxShortStack || (short_stack & (short_stack - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = short_stack * kWalkThreads * static_cast<int>(sizeof(int32_t));
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  kWalkThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (num_rays + kWalkThreads - 1) / kWalkThreads;
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
  if (blocks > grid) blocks = grid;
  out[0] = static_cast<int>(blocks);
  out[1] = kWalkThreads;
  out[2] = smem;
  out[3] = per_sm;
  return 0;
}

// Launch `kernel(args..., ring_mask, counter)` on `stream`; `counter` is
// one zeroed u64 the warps count rays on. Returns cudaGetLastError() after
// the launch.
template <class Kernel, class... Args>
int launch_walk(Kernel kernel, int64_t num_rays, int short_stack,
                 unsigned long long* counter, cudaStream_t stream, Args... args) {
  if (counter == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int shape[4];
  const int err = walk_shape(kernel, short_stack, num_rays, shape);
  if (err != 0) return err;
  kernel<<<shape[0], shape[1], shape[2], stream>>>(args..., short_stack - 1, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wt
