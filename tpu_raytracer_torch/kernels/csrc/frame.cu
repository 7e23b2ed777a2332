// CUDA entry points of the frame's stages S1 (raygen), S2 (hit attributes),
// S3 (primary shade), S4 (sample), S5 (Whitted shade) and S6 (path
// bounce), whose per-ray math is frame.cuh.
//
// S1 replaces render/camera.py generate_rays_torch (the JAX package's
// tpu_raytracer/render/camera.py:113 generate_rays, which XLA fuses ahead
// of the Pallas cast), S2 render/renderer.py hit_attributes_torch
// (tpu_raytracer/render/renderer.py:232) and S3 render/shade.py
// shade_primary_torch (tpu_raytracer/render/shade.py:385) on every config:
// flat, Lambert, Lambert with shadows and Blinn-Phong, point lights,
// nearest, bilinear or trilinear textures or albedo, the flat sky or the
// scene's sky map. The shadow rays are cast between S2 and S3 and their
// answer comes in as an input.
//
// What bounds them on an H100: bytes. Each is one thread per ray (per
// pixel for S1), a few hundred f32 operations at most against 12-150
// bytes read or written per ray, so at the card's 3.35 TB/s and 67 f32
// TFLOP/s the memory takes longer. The design is the simplest that moves
// each byte once: consecutive threads on consecutive rays, so a warp's
// reads and writes of the per-ray rows are coalesced; the scene tables
// (triangle rows, instance rows, materials, the texture atlas) are read
// through the read-only path (const __restrict__), S2's gathers at the
// hit triangle's rows. The per-frame inputs (the camera's K_inv, D and
// inverse pose, the instance rows) are read through device pointers on
// every launch, so a CUDA graph that captured the launch renders the pose
// and instances copied into them before each replay; each thread derives
// the quaternions from them itself (the same sinf and cosf of the same
// input give the same bits on every thread). Vectorized stores of the
// 12-byte rows are later work.
//
// S4 (render/integrators.py sample_cosine_torch: utils/prng.py's threefry
// draws and _cosine_sample, the frame's sample stage) is bounded by integer
// operations: each ray hashes two counters (three with the path tracer's
// lobe draw), ~100 uint32 operations a hash, against 24-28 bytes read and
// written. It keeps every word in registers (the eager version makes one
// int64 round trip through device memory per operation) and derives the
// draw's key once per block: thread 0 folds the frame's key words, read
// through a device pointer so a captured graph replays the key copied in,
// with the chain's words into shared memory. The grid is capped at
// kSampleBlocksPerSM blocks per SM, each striding over the rays, so that
// derivation is paid by ~1,000 blocks rather than one block per 256 rays.
//
// S5 (render/integrators.py whitted_shade_torch, the shade body of one
// Whitted bounce, ~100 eager PyTorch ops) is bounded by bytes too: one
// thread per ray reads ~90 bytes (the direction, the hit attributes, the
// light term, the radiance and throughput carried over) and writes ~50
// (radiance, throughput, the active flag, the next bounce's parked ray),
// with the sky, the texel, the sums and the reflected ray in registers.
// The first bounce reads no state (it starts from 0, 1 and true), and the
// last writes no rays.
//
// S6 (render/integrators.py path_bounce_torch, the bounce body of the path
// tracer, ~50 eager PyTorch ops a bounce) is bounded by bytes as S5 is: one
// thread per ray reads ~100 bytes (the direction, the hit attributes, S4's
// cosine sample and lobe uniform, the state carried over) and writes ~50
// (the state, the next bounce's parked ray). The batched wavefront's first
// bounce hands its primary rows once for all samples (ray r reads row
// r % period), never copied, and reads no state. A thread takes one row and
// the rays that read it (q, q + period, ...), so each row is loaded from
// device memory once and its other reads meet the cache. Its tail mode is
// the fast tail's sky term after the any-hit cast: ~40 bytes a ray.
//
// Built with K1-K6 into one library (kernels/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c frame.cu
#include <cuda_runtime.h>

#include <algorithm>

#include "frame.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

int blocks_for(int64_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

__global__ void __launch_bounds__(kThreads)
frame_raygen_kernel(int width, int64_t num_pixels, const float* __restrict__ K_inv,
                    const float* __restrict__ D, const float* __restrict__ inv_pose, int exact,
                    float* __restrict__ dirs) {
  const int64_t i = thread_index();
  if (i >= num_pixels) return;
  float K[9], Dk[4], q[4];
  for (int k = 0; k < 9; ++k) K[k] = K_inv[k];
  for (int k = 0; k < 4; ++k) Dk[k] = D[k];
  fr::euler2quat(inv_pose + 3, q);
  fr::raygen(static_cast<int>(i % width), static_cast<int>(i / width), K, Dk, q, exact != 0,
             dirs + 3 * i);
}

__global__ void __launch_bounds__(kThreads)
frame_attrs_kernel(fr::AttrScene s, fr::AttrRays in, int64_t num_rays, int exact,
                   int normal_mode, fr::AttrOut out) {
  const int64_t r = thread_index();
  if (r < num_rays) fr::attributes(s, in, r, exact != 0, normal_mode, out);
}

__global__ void __launch_bounds__(kThreads)
frame_shade_kernel(fr::ShadeScene s, fr::ShadeParams p, fr::ShadeRays in, int64_t num_rays,
                   uint8_t* __restrict__ out) {
  const int64_t r = thread_index();
  if (r < num_rays) fr::shade(s, p, in, r, out);
}

__global__ void __launch_bounds__(kThreads)
frame_whitted_shade_kernel(fr::ShadeScene s, fr::ShadeParams p, fr::ShadeRays in,
                           fr::WhittedState w) {
  const int64_t r = thread_index();
  if (r < in.num_rays) fr::whitted_shade(s, p, in, w, r);
}

__global__ void __launch_bounds__(kThreads)
frame_path_bounce_kernel(fr::ShadeScene s, fr::ShadeParams p, fr::ShadeRays in,
                         fr::PathBounce b) {
  const int64_t q = thread_index();
  if (q >= b.period) return;
  for (int64_t r = q; r < in.num_rays; r += b.period) fr::path_bounce(s, p, in, b, r, q);
}

constexpr int kSampleBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads)
frame_sample_kernel(const int64_t* __restrict__ key, fr::SampleChain chain, fr::SampleArgs a) {
  __shared__ uint32_t keys[4];
  if (threadIdx.x == 0) fr::sample_keys(key, chain, keys);
  __syncthreads();
  const uint32_t k[4] = {keys[0], keys[1], keys[2], keys[3]};
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = thread_index(); r < a.num_rays; r += step) fr::sample(a, k, r);
}

// The SMs of the current device, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace

// S4 on `stream`: one draw's cosine samples dirs [num_rays, 3] around the
// normals (read through their strides, fr::SampleArgs) and, where `lobe`
// is not null, its lobe uniforms [num_rays]. `key` [2] lies on the card;
// the chain's `chain_len` words (at most fr::kMaxChain) are w0..w3.
extern "C" int frame_sample_launch(const int64_t* key, int chain_len, uint32_t w0, uint32_t w1,
                                   uint32_t w2, uint32_t w3, uint32_t lobe_word,
                                   const float* normal, int64_t inner, int64_t stride_outer,
                                   int64_t stride_inner, int64_t stride_comp, int64_t num_rays,
                                   int exact, float* dirs, float* lobe, void* stream) {
  const fr::SampleChain c{chain_len, {w0, w1, w2, w3}, lobe != nullptr, lobe_word};
  const fr::SampleArgs a{normal, inner, stride_outer, stride_inner, stride_comp, num_rays,
                         exact, dirs, lobe};
  if (key == nullptr || !fr::sample_args_ok(c, a)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = static_cast<int64_t>(sm_count()) * kSampleBlocksPerSM;
  const int blocks = static_cast<int>(std::min<int64_t>(blocks_for(num_rays), cap));
  frame_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(key, c, a);
  return static_cast<int>(cudaGetLastError());
}

// S1 on `stream`: directions [height, width, 3] of the camera whose K_inv
// [3, 3], D [4] and inverse pose [6] lie on the card. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int frame_raygen_launch(int width, int height, const float* K_inv, const float* D,
                                   const float* inv_pose, int exact, float* dirs, void* stream) {
  const int64_t n = static_cast<int64_t>(width) * height;
  if (width <= 0 || height <= 0) return static_cast<int>(cudaErrorInvalidValue);
  frame_raygen_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      width, n, K_inv, D, inv_pose, exact, dirs);
  return static_cast<int>(cudaGetLastError());
}

// S2 on `stream` over `num_rays` rays. `u`, `v` and `n` are the carried
// fields (null: not carried), `tri_vnorm` null for a scene without vertex
// normals, `normal_mode` fr::NormalMode.
extern "C" int frame_attrs_launch(
    const float* tri_v0, const float* tri_v1, const float* tri_v2, const float* tri_normal,
    const float* tri_uv0, const float* tri_uv1, const float* tri_uv2, const float* tri_vnorm,
    const int32_t* tri_mat, const float* inst_pose, const float* inst_inv_pose,
    const float* inst_scale, const float* inst_inv_scale, const int32_t* inst_material,
    int num_instances, const float* origin, int origin_stride, const float* dirs,
    int64_t num_rays, const float* t, const int32_t* tri, const int32_t* inst, const float* u,
    const float* v, const float* n, int exact, int normal_mode, uint8_t* hit_out,
    float* location, float* normal, float* uv, int64_t* material, int64_t* inst_out,
    void* stream) {
  if (num_rays <= 0 || num_instances <= 0 || (u == nullptr) != (v == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fr::AttrScene s{tri_v0, tri_v1, tri_v2, tri_normal, tri_uv0, tri_uv1, tri_uv2,
                        tri_vnorm, tri_mat, inst_pose, inst_inv_pose, inst_scale,
                        inst_inv_scale, inst_material, num_instances};
  const fr::AttrRays in{origin, origin_stride, dirs, t, tri, inst, u, v, n};
  const fr::AttrOut out{hit_out, location, normal, uv, material, inst_out};
  frame_attrs_kernel<<<blocks_for(num_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, in, num_rays, exact, normal_mode, out);
  return static_cast<int>(cudaGetLastError());
}

// S3 on `stream` over `num_rays` rays: u8 colours [num_rays, 3]. `mode`
// fr::Mode, `filter` fr::Filter; the inputs a config does not read may be
// null (fr::ShadeRays says which). The point lights [L, 4] and their
// shadow rays' t [L, num_rays] lie on the card.
extern "C" int frame_shade_launch(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky, const uint8_t* hit,
    const float* normal, const float* uv, const int64_t* material, const int64_t* inst,
    const float* location, const float* dirs, const uint8_t* lit, const float* point_lights,
    const float* point_occ_t, int64_t num_rays, int mode, int has_light, float lx, float ly,
    float lz, int exact, float specular, float shininess, int filter, int height, int width,
    int num_point_lights, int point_shadows, uint8_t* out, void* stream) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{mode, has_light, {lx, ly, lz}, exact, specular, shininess,
                          filter, height, width, num_point_lights, point_shadows};
  const fr::ShadeRays in{hit, normal, uv, material, inst, location, dirs, lit, point_lights,
                         point_occ_t, num_rays};
  if (!fr::shade_args_ok(s, p, in)) return static_cast<int>(cudaErrorInvalidValue);
  frame_shade_kernel<<<blocks_for(num_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, p, in, num_rays, out);
  return static_cast<int>(cudaGetLastError());
}

// S5 on `stream` over one Whitted bounce of `num_rays` rays: `radiance`,
// `throughput` [num_rays, 3] and `active` updated in place (at `first`
// written from 0, 1 and true), and unless `last` the next bounce's rays in
// `origin_out` and `dirs_out` [num_rays, 3]. `filter` fr::Filter
// (trilinear samples bilinear); the tables are S3's, then the materials'
// reflectivity and illumination [K].
extern "C" int frame_whitted_shade_launch(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky,
    const float* mat_reflectivity, const float* mat_illumination, const float* dirs,
    const uint8_t* hit, const float* location, const float* normal, const float* uv,
    const int64_t* material, const float* illum, int64_t num_rays, int filter, int exact,
    int first, int last, float* radiance, float* throughput, uint8_t* active,
    float* origin_out, float* dirs_out, void* stream) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{fr::kFlat, 0, {0.0f, 0.0f, 0.0f}, exact, 0.0f, 0.0f, filter, 0, 0, 0, 0};
  const fr::ShadeRays in{hit, normal, uv, material, nullptr, location, dirs, nullptr, nullptr,
                         nullptr, num_rays};
  const fr::WhittedState w{illum, mat_reflectivity, mat_illumination, radiance, throughput,
                           active, origin_out, dirs_out, first, last};
  if (!fr::whitted_args_ok(s, p, in, w)) return static_cast<int>(cudaErrorInvalidValue);
  frame_whitted_shade_kernel<<<blocks_for(num_rays), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(s, p, in, w);
  return static_cast<int>(cudaGetLastError());
}

// S6 on `stream` over one path-tracing bounce of `num_rays` rays: `radiance`,
// `throughput` [num_rays, 3] and `active` updated in place (at `first`
// written from 0, 1 and true), and the next bounce's rays in `origin_out`
// and `dirs_out` [num_rays, 3]; with `tail` the fast tail's sky term on the
// radiance alone, from the any-hit cast's `t`. `dirs`, `hit`, `location`,
// `normal`, `uv` and `material` hold `period` rows, ray r reading row
// r % period; `t`, `d_diff`, `lobe` and `illum` (null: NEE off) one per
// ray. `filter`
// fr::Filter (trilinear samples bilinear); the tables are S3's, then the
// materials' reflectivity, illumination and roughness [K].
extern "C" int frame_path_bounce_launch(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky,
    const float* mat_reflectivity, const float* mat_illumination, const float* mat_roughness,
    const float* dirs, const uint8_t* hit, const float* location, const float* normal,
    const float* uv, const int64_t* material, int64_t period, const float* t,
    const float* d_diff, const float* lobe, const float* illum, int64_t num_rays, int filter,
    int exact, int first, int tail, float sky_strength, float light_scale, float* radiance,
    float* throughput, uint8_t* active, float* origin_out, float* dirs_out, void* stream) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{fr::kFlat, 0, {0.0f, 0.0f, 0.0f}, exact, 0.0f, 0.0f, filter, 0, 0, 0, 0};
  const fr::ShadeRays in{hit, normal, uv, material, nullptr, location, dirs, nullptr, nullptr,
                         nullptr, num_rays};
  const fr::PathBounce b{mat_reflectivity, mat_illumination, mat_roughness, t, d_diff, lobe,
                         illum, period, sky_strength, light_scale, radiance, throughput,
                         active, origin_out, dirs_out, first, tail};
  if (!fr::path_args_ok(s, p, in, b)) return static_cast<int>(cudaErrorInvalidValue);
  frame_path_bounce_kernel<<<blocks_for(period), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(s, p, in, b);
  return static_cast<int>(cudaGetLastError());
}
