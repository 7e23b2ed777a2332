// CUDA entry point of K6's plan (page_plan.cuh says what it computes and
// why it equals the plain version kernels/paged_major.py:page_major_plan
// bit for bit). Four launches on one stream, none waiting on the host:
//   init:  every item's key +inf;
//   tiles: one block per tile of kTileRays rays, one thread per ray: per
//          instance the object-space ray, the bounds as a block reduction
//          (warp shuffles, then one value per warp), then the items' tests,
//          the wanted bits, an atomic min into each wanted item's key, and
//          the tile's count of wanted items;
//   order: one block: each item's rank by (key, index), which places it;
//          the tiles' list starts as a prefix sum of their counts;
//   lists: one block per tile: its wanted items in plan order, placed by a
//          block scan (warp ballots).
// The kernel K6 reads the list starts and the lists from device memory.
//
// Replaces the host plan that ran in front of K6 (eager PyTorch over
// [tiles, pages, 3] tensors, an argsort and a host sync for the count of
// seen items). Its bound on the H100 is bytes (the rays read once), 7.5
// us at 1920x1088 on the colonnade; the four launches take 72 us of
// device time there (PERF.md section 6), most of it the tiles kernel's
// f32 work (~100 operations per (tile, item) and per ray and instance)
// and the launches' own latency. The order kernel's K^2 / 1024
// comparisons per thread are few for the scenes here (K = 217 and 434).
//
// Built with the other kernels into one library (kernels/build.py), plain
// C interface bound with ctypes.
#include <cuda_runtime.h>

#include "page_plan.cuh"

namespace {

constexpr int kThreads = wt::kTileRays;  // one thread per ray of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kOrderThreads = 1024;

// Atomic min of a float: an int min where the sign bit is clear, an
// unsigned max where it is set (larger magnitudes of negative floats are
// larger unsigned words). Exact for every non-NaN value, signed zeros
// included; the key starts at +inf.
__device__ __forceinline__ void atomic_min_key(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void page_plan_init_kernel(float* key, int num_items) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < num_items) key[k] = __int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(kThreads)
page_plan_tiles_kernel(wt::PlanInput in, wt::PlanOutput out) {
  __shared__ float part[kWarps][12];
  __shared__ wt::TileBounds tb;
  __shared__ int32_t warp_count[kWarps];
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t num_items = in.num_items();
  float wo[3], wd[3];
  in.ray(tile, threadIdx.x, wo, wd);
  int32_t count = 0;
  for (int i = 0; i < in.num_instances; ++i) {
    float o[3], d[3], inv[3], v[6];
    wt::object_ray(in.inst_tab + 12 * i, wo, wd, o, d, inv);
    wt::bounds_values(o, inv, v);
    float lo[6], hi[6];
    for (int q = 0; q < 6; ++q) {
      lo[q] = v[q];
      hi[q] = v[q];
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int q = 0; q < 6; ++q) {
        lo[q] = fminf(lo[q], __shfl_xor_sync(0xffffffffu, lo[q], off));
        hi[q] = fmaxf(hi[q], __shfl_xor_sync(0xffffffffu, hi[q], off));
      }
    }
    if (lane == 0) {
      for (int q = 0; q < 6; ++q) {
        part[warp][q] = lo[q];
        part[warp][6 + q] = hi[q];
      }
    }
    __syncthreads();
    if (threadIdx.x < 6) {
      const int q = threadIdx.x;
      float l = part[0][q], h = part[0][6 + q];
      for (int w = 1; w < kWarps; ++w) {
        l = fminf(l, part[w][q]);
        h = fmaxf(h, part[w][6 + q]);
      }
      tb.lo[q] = wt::widen_lo(l);
      tb.hi[q] = wt::widen_hi(h);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < in.num_pages; p += kThreads) {
      const int32_t k = i * in.num_pages + p;
      float near_lo;
      const bool want = in.test(tb, k, &near_lo);
      out.wanted[tile * num_items + k] = want ? 1 : 0;
      if (want) {
        atomic_min_key(out.key + k, near_lo);
        ++count;
      }
    }
    __syncthreads();  // tb and part are rewritten for the next instance
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    out.tile_count[tile] = total;
  }
}

__global__ void __launch_bounds__(kOrderThreads)
page_plan_order_kernel(wt::PlanInput in, wt::PlanOutput out, int64_t num_tiles) {
  __shared__ int32_t part[kOrderThreads];
  const int32_t num_items = in.num_items();
  for (int32_t k = threadIdx.x; k < num_items; k += kOrderThreads) {
    const int32_t r = wt::item_rank(out.key, num_items, k);
    out.item_pid[r] = k % in.num_pages;
    out.item_iid[r] = k / in.num_pages;
  }
  // exclusive prefix sum of the tile counts: a run of tiles per thread,
  // then a scan of the runs' sums
  const int64_t run = (num_tiles + kOrderThreads - 1) / kOrderThreads;
  const int64_t lo = threadIdx.x * run;
  const int64_t hi = lo + run < num_tiles ? lo + run : num_tiles;
  int32_t sum = 0;
  for (int64_t t = lo; t < hi; ++t) sum += out.tile_count[t];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kOrderThreads; off <<= 1) {
    const int32_t add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int32_t start = part[threadIdx.x] - sum;
  for (int64_t t = lo; t < hi; ++t) {
    out.tile_start[t] = start;
    start += out.tile_count[t];
  }
  if (threadIdx.x == kOrderThreads - 1) out.tile_start[num_tiles] = part[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
page_plan_lists_kernel(wt::PlanInput in, wt::PlanOutput out) {
  __shared__ int32_t warp_total[kWarps];
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t num_items = in.num_items();
  const uint8_t* row = out.wanted + tile * num_items;
  int32_t next = out.tile_start[tile];
  for (int32_t j0 = 0; j0 < num_items; j0 += kThreads) {
    const int32_t j = j0 + threadIdx.x;
    const bool want =
        j < num_items && row[out.item_iid[j] * in.num_pages + out.item_pid[j]] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, want);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int32_t before = __popc(ballot & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_total[w] : 0;
      total += warp_total[w];
    }
    if (want) out.tile_item[next + before] = j;
    next += total;
    __syncthreads();  // warp_total is rewritten for the next chunk
  }
}

}  // namespace

// The plan of `num_rays` rays in tile order on `stream` (page_plan.cuh's
// PlanInput and PlanOutput fields, in order); returns cudaGetLastError()
// after the last launch (0 on success), or cudaErrorInvalidValue for a
// plan of no items.
extern "C" int page_plan_launch(const float* origin, int origin_stride, const float* dirs,
                                int64_t num_rays, const float* inst_tab,
                                const int32_t* inst_mesh, int num_instances,
                                const float* node_min, const float* node_max,
                                const int32_t* page_node0, int num_pages,
                                const int32_t* mesh_root, int num_meshes, uint8_t* wanted,
                                int32_t* tile_count, float* key,
                                int32_t* item_pid, int32_t* item_iid, int32_t* tile_start,
                                int32_t* tile_item, void* stream) {
  const wt::PlanInput in{origin,   origin_stride, dirs,       num_rays,  inst_tab,
                         inst_mesh, num_instances, node_min,   node_max,  page_node0,
                         num_pages, mesh_root,     num_meshes};
  const wt::PlanOutput out{wanted, tile_count, key, item_pid, item_iid, tile_start, tile_item};
  const int32_t items = in.num_items();
  if (items <= 0 || num_rays < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = in.num_tiles();
  page_plan_init_kernel<<<(items + 255) / 256, 256, 0, st>>>(key, items);
  if (tiles > 0) {
    page_plan_tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(in, out);
  }
  page_plan_order_kernel<<<1, kOrderThreads, 0, st>>>(in, out, tiles);
  if (tiles > 0) {
    page_plan_lists_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(in, out);
  }
  return static_cast<int>(cudaGetLastError());
}
