// Host builds of the frame stages' per-ray math (frame.cuh) for the CPU
// tests: the code S1-S6 run on the card, looped over pixels or
// rays, with the same C interface as frame.cu's launchers less the stream.
// The host has no rsqrtf: torch.rsqrt is 1/sqrtf here, as in ATen's CPU
// kernel; atanf, atan2f, asinf, log2f, sinf, cosf and powf are the C
// library's.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC -o libframe_host.so frame_host.cpp
#include "frame.cuh"

extern "C" int frame_raygen_host(int width, int height, const float* K_inv, const float* D,
                                 const float* inv_pose, int exact, float* dirs) {
  if (width <= 0 || height <= 0) return 1;
  float q[4];
  fr::euler2quat(inv_pose + 3, q);
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      fr::raygen(x, y, K_inv, D, q, exact != 0, dirs + 3 * (static_cast<int64_t>(y) * width + x));
    }
  }
  return 0;
}

extern "C" int frame_attrs_host(
    const float* tri_v0, const float* tri_v1, const float* tri_v2, const float* tri_normal,
    const float* tri_uv0, const float* tri_uv1, const float* tri_uv2, const float* tri_vnorm,
    const int32_t* tri_mat, const float* inst_pose, const float* inst_inv_pose,
    const float* inst_scale, const float* inst_inv_scale, const int32_t* inst_material,
    int num_instances, const float* origin, int origin_stride, const float* dirs,
    int64_t num_rays, const float* t, const int32_t* tri, const int32_t* inst, const float* u,
    const float* v, const float* n, int exact, int normal_mode, uint8_t* hit_out,
    float* location, float* normal, float* uv, int64_t* material, int64_t* inst_out) {
  if (num_rays <= 0 || num_instances <= 0 || (u == nullptr) != (v == nullptr)) return 1;
  const fr::AttrScene s{tri_v0, tri_v1, tri_v2, tri_normal, tri_uv0, tri_uv1, tri_uv2,
                        tri_vnorm, tri_mat, inst_pose, inst_inv_pose, inst_scale,
                        inst_inv_scale, inst_material, num_instances};
  const fr::AttrRays in{origin, origin_stride, dirs, t, tri, inst, u, v, n};
  const fr::AttrOut out{hit_out, location, normal, uv, material, inst_out};
  for (int64_t r = 0; r < num_rays; ++r) fr::attributes(s, in, r, exact != 0, normal_mode, out);
  return 0;
}

extern "C" int frame_shade_host(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky, const uint8_t* hit,
    const float* normal, const float* uv, const int64_t* material, const int64_t* inst,
    const float* location, const float* dirs, const uint8_t* lit, const float* point_lights,
    const float* point_occ_t, int64_t num_rays, int mode, int has_light, float lx, float ly,
    float lz, int exact, float specular, float shininess, int filter, int height, int width,
    int num_point_lights, int point_shadows, uint8_t* out) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{mode, has_light, {lx, ly, lz}, exact, specular, shininess,
                          filter, height, width, num_point_lights, point_shadows};
  const fr::ShadeRays in{hit, normal, uv, material, inst, location, dirs, lit, point_lights,
                         point_occ_t, num_rays};
  if (!fr::shade_args_ok(s, p, in)) return 1;
  for (int64_t r = 0; r < num_rays; ++r) fr::shade(s, p, in, r, out);
  return 0;
}

extern "C" int frame_sample_host(const int64_t* key, int chain_len, uint32_t w0, uint32_t w1,
                                 uint32_t w2, uint32_t w3, uint32_t lobe_word,
                                 const float* normal, int64_t inner, int64_t stride_outer,
                                 int64_t stride_inner, int64_t stride_comp, int64_t num_rays,
                                 int exact, float* dirs, float* lobe) {
  const fr::SampleChain c{chain_len, {w0, w1, w2, w3}, lobe != nullptr, lobe_word};
  const fr::SampleArgs a{normal, inner, stride_outer, stride_inner, stride_comp, num_rays,
                         exact, dirs, lobe};
  if (key == nullptr || !fr::sample_args_ok(c, a)) return 1;
  uint32_t keys[4];
  fr::sample_keys(key, c, keys);
  for (int64_t r = 0; r < num_rays; ++r) fr::sample(a, keys, r);
  return 0;
}

extern "C" int frame_whitted_shade_host(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky,
    const float* mat_reflectivity, const float* mat_illumination, const float* dirs,
    const uint8_t* hit, const float* location, const float* normal, const float* uv,
    const int64_t* material, const float* illum, int64_t num_rays, int filter, int exact,
    int first, int last, float* radiance, float* throughput, uint8_t* active,
    float* origin_out, float* dirs_out) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{fr::kFlat, 0, {0.0f, 0.0f, 0.0f}, exact, 0.0f, 0.0f, filter, 0, 0, 0, 0};
  const fr::ShadeRays in{hit, normal, uv, material, nullptr, location, dirs, nullptr, nullptr,
                         nullptr, num_rays};
  const fr::WhittedState w{illum, mat_reflectivity, mat_illumination, radiance, throughput,
                           active, origin_out, dirs_out, first, last};
  if (!fr::whitted_args_ok(s, p, in, w)) return 1;
  for (int64_t r = 0; r < num_rays; ++r) fr::whitted_shade(s, p, in, w, r);
  return 0;
}

extern "C" int frame_path_bounce_host(
    const float* mat_albedo, const int32_t* mat_tex_start, const int32_t* mat_tex_w,
    const int32_t* mat_tex_h, const int32_t* mat_tex_mip_start, int num_levels,
    const int32_t* tex_atlas, int64_t atlas_size, int textured, const int32_t* sky_tex_start,
    const int32_t* sky_tex_w, const int32_t* sky_tex_h, int has_sky,
    const float* mat_reflectivity, const float* mat_illumination, const float* mat_roughness,
    const float* dirs, const uint8_t* hit, const float* location, const float* normal,
    const float* uv, const int64_t* material, int64_t period, const float* t,
    const float* d_diff, const float* lobe, const float* illum, int64_t num_rays, int filter,
    int exact, int first, int tail, float sky_strength, float light_scale, float* radiance,
    float* throughput, uint8_t* active, float* origin_out, float* dirs_out) {
  const fr::ShadeScene s{mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
                         num_levels, tex_atlas, atlas_size, textured, sky_tex_start, sky_tex_w,
                         sky_tex_h, has_sky};
  const fr::ShadeParams p{fr::kFlat, 0, {0.0f, 0.0f, 0.0f}, exact, 0.0f, 0.0f, filter, 0, 0, 0, 0};
  const fr::ShadeRays in{hit, normal, uv, material, nullptr, location, dirs, nullptr, nullptr,
                         nullptr, num_rays};
  const fr::PathBounce b{mat_reflectivity, mat_illumination, mat_roughness, t, d_diff, lobe,
                         illum, period, sky_strength, light_scale, radiance, throughput,
                         active, origin_out, dirs_out, first, tail};
  if (!fr::path_args_ok(s, p, in, b)) return 1;
  for (int64_t q = 0; q < period; ++q) {
    for (int64_t r = q; r < num_rays; r += period) fr::path_bounce(s, p, in, b, r, q);
  }
  return 0;
}
