// The per-ray math of the frame's stages S1-S6, for nvcc and g++.
//
//   S1 raygen (raygen): one primary ray direction per pixel. Replaces
//      render/camera.py generate_rays_torch, the port of the JAX package's
//      XLA-fused tpu_raytracer/render/camera.py:113 generate_rays.
//   S2 hit attributes (attributes): world location, normal, uv, material
//      and instance of one hit record, through the redo branch or the
//      carried one. Replaces render/renderer.py hit_attributes_torch, the
//      port of tpu_raytracer/render/renderer.py:232 hit_attributes.
//   S3 primary shade (shade): the u8 colour of one primary ray: the
//      nearest, bilinear or trilinear texel or the albedo; flat, Lambert,
//      Lambert with the shadow answer given or Blinn-Phong illumination
//      plus the point lights (their shadow rays' t given), clamped to
//      [0.4, 1]; the truncating u8 cast; the flat sky or the sky map.
//      Replaces render/shade.py shade_primary_torch, the port of
//      tpu_raytracer/render/shade.py:385 shade_primary.
//   S4 sample (sample_keys, sample): the cosine-weighted hemisphere sample
//      of one ray and, for the path tracer, its lobe draw, from the frame's
//      key through a short chain of fold_in words: threefry2x32, uniform
//      and _cosine_sample on uint32 and f32 in registers. Replaces
//      render/integrators.py sample_cosine_torch (utils/prng.py fold_in and
//      uniform, integrators._cosine_sample), the port of
//      tpu_raytracer/render/integrators.py's _cosine_sample and the jax.random
//      draws XLA fuses around it.
//   S5 Whitted shade (whitted_shade): one bounce of render/integrators.py
//      render_whitted after its light stage: the sky on a miss (flat, as
//      f32 radiance, or the sky map), the surface colour (nearest, or
//      bilinear: secondary rays have no screen derivatives), the clamped
//      illumination, the material's reflectivity and emission, the two
//      radiance sums and the throughput, and the next bounce's reflected
//      rays, offset and parked. Replaces render/integrators.py
//      whitted_shade_torch, the port of the shade body of
//      tpu_raytracer/render/integrators.py's render_whitted.
//   S6 path bounce (path_bounce): one bounce of render/integrators.py
//      render_path_traced after its sample draw: the sky on a miss times
//      its strength, the surface colour (as S5's), the emission, the
//      throughput times the colour, the light term where NEE is on, the
//      glossy lobe (the mirror blended toward the cosine sample by the
//      roughness, the cosine sample below the surface) chosen by the lobe
//      uniform, and the next bounce's rays, offset and parked; in its tail
//      mode the fast tail's sky term after the any-hit cast. Replaces
//      render/integrators.py path_bounce_torch, the port of the bounce body
//      of tpu_raytracer/render/integrators.py's render_path_traced.
//
// Each function repeats its plain version's f32 operations in their order,
// one rounding per PyTorch op: sums of dot products left to right (core/
// vecmath.py dot), `x ** 2` as x*x, `x ** 3` as x*x*x, `x ** 4` and
// `spec ** 32.0` as powf, `1.0 / x` as one IEEE divide, atan, atan2, asin,
// log2, sin and cos as the full-precision atanf, atan2f, asinf, log2f,
// sinf and cosf, and torch.rsqrt as rsqrtf on the card (ATen's CUDA
// kernel) and 1/sqrtf on the host (ATen's CPU one).
// Build with --fmad=false (nvcc) or -ffp-contract=off (g++), without
// --use_fast_math: a fused multiply-add rounds once where the plain
// version rounds twice.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define FR_HD __host__ __device__ __forceinline__
#else
#define FR_HD static inline
#endif

namespace fr {

constexpr float kFltMax = 3.4028235e38f;  // the miss sentinel of t
constexpr float kParallelEps = 1e-6f;     // render/intersect.py PARALLEL_EPS
constexpr float kTexelScale = 0.0039215f;  // render/shade.py TEXEL_SCALE
constexpr float kShadowed = 0.4f;         // a shadowed hit's share of the cosine
constexpr float kIllumFloor = 0.4f;       // illumination clamp [0.4, 1]
constexpr float kIllumCeil = 1.0f;

// S3's lighting modes and S2's normal modes (kernels/frame.py MODES,
// NORMAL_MODES).
enum Mode { kFlat = 0, kLambert = 1, kLambertShadow = 2, kBlinnPhong = 3 };
enum NormalMode { kReference = 0, kInverseTranspose = 1 };

// torch.rsqrt: rsqrtf on the card, 1/sqrt on the host.
FR_HD float rsqrt_t(float x) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// core/vecmath.py q_rsqrt: 0x5f3759df and one Newton step, the int32
// arithmetic wrapping as PyTorch's does.
FR_HD float q_rsqrt(float x) {
  int32_t i;
  memcpy(&i, &x, sizeof(i));
  i = static_cast<int32_t>(0x5F3759DFu - static_cast<uint32_t>(i >> 1));
  float y;
  memcpy(&y, &i, sizeof(y));
  return y * (1.5f - x * 0.5f * y * y);
}

FR_HD float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// core/vecmath.py normalize, in place.
FR_HD void normalize(float* v, bool exact) {
  const float sq = dot3(v, v);
  const float inv = exact ? rsqrt_t(sq) : q_rsqrt(sq);
  for (int k = 0; k < 3; ++k) v[k] = v[k] * inv;
}

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): NaN passes through.
FR_HD float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
FR_HD float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// core/transforms.py euler2quat: (w, x, y, z) of (yaw, pitch, roll).
FR_HD void euler2quat(const float* e, float* q) {
  const float hy = e[0] * 0.5f, hp = e[1] * 0.5f, hr = e[2] * 0.5f;
  const float sy = sinf(hy), cy = cosf(hy);
  const float sp = sinf(hp), cp = cosf(hp);
  const float sr = sinf(hr), cr = cosf(hr);
  q[0] = sy * sp * sr + cy * cp * cr;
  q[1] = cy * sp * cr + sy * cp * sr;
  q[2] = -sy * sp * cr + cy * cp * sr;
  q[3] = cy * sp * sr - sy * cp * cr;
}

// core/transforms.py apply_quat.
FR_HD void quat_rot(const float* q, const float* v, float* out) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float a = -v[0] * qx - v[1] * qy - v[2] * qz;
  const float b = v[0] * qw + v[1] * qz - v[2] * qy;
  const float c = v[1] * qw + v[2] * qx - v[0] * qz;
  const float d = v[2] * qw + v[0] * qy - v[1] * qx;
  out[0] = qw * b - qx * a - qy * d + qz * c;
  out[1] = qw * c - qy * a - qz * b + qx * d;
  out[2] = qw * d - qz * a - qx * c + qy * b;
}

// ---------------------------------------------------------------------------
// S1 raygen
// ---------------------------------------------------------------------------

// The direction of pixel (x, y): K_inv [3, 3] row-major, D [4] the
// Kannala-Brandt coefficients, q the quaternion of the inverse pose's
// euler angles (euler2quat).
FR_HD void raygen(int x, int y, const float* K, const float* D, const float* q, bool exact,
                  float* out) {
  const float px = static_cast<float>(x), py = static_cast<float>(y), one = 1.0f;
  float dir[3];
  for (int k = 0; k < 3; ++k) dir[k] = K[3 * k] * px + K[3 * k + 1] * py + K[3 * k + 2] * one;
  const float a = dir[0], b = dir[1];
  const float radius = sqrtf(a * a + b * b);
  const float theta = atanf(radius);
  const float poly = 1.0f + D[0] * theta + D[1] * (theta * theta)
                     + D[2] * (theta * theta * theta) + D[3] * powf(theta, 4.0f);
  const float thetad = theta * poly;
  const float scale = radius > 0.0f ? thetad / radius : 1.0f;
  float v[3] = {scale * a, scale * b, dir[2]};
  normalize(v, exact);
  const float swapped[3] = {v[0], v[2], -v[1]};  // y forward, z up
  quat_rot(q, swapped, out);
  normalize(out, exact);
}

// ---------------------------------------------------------------------------
// S2 hit attributes
// ---------------------------------------------------------------------------

// The scene tables S2 reads (kernels/frame.py attr_tables).
struct AttrScene {
  const float* tri_v0;      // [T, 3]
  const float* tri_v1;
  const float* tri_v2;
  const float* tri_normal;
  const float* tri_uv0;     // [T, 2]
  const float* tri_uv1;
  const float* tri_uv2;
  const float* tri_vnorm;   // [T, 10] vertex normals and flag, or null
  const int32_t* tri_mat;   // [T]
  const float* inst_pose;   // [I, 6]
  const float* inst_inv_pose;
  const float* inst_scale;  // [I, 3]
  const float* inst_inv_scale;
  const int32_t* inst_material;  // [I]
  int num_instances;
};

// One cast's rays and hit record; u, v, n null where the cast did not
// carry them. `origin_stride` is 0 for one shared origin, 3 for per-ray.
struct AttrRays {
  const float* origin;
  int origin_stride;
  const float* dirs;
  const float* t;
  const int32_t* tri;
  const int32_t* inst;
  const float* u;
  const float* v;
  const float* n;
};

struct AttrOut {
  uint8_t* hit;       // bool
  float* location;    // [R, 3]
  float* normal;      // [R, 3]
  float* uv;          // [R, 2]
  int64_t* material;
  int64_t* inst;
};

FR_HD void load3(const float* p, float* out) {
  for (int k = 0; k < 3; ++k) out[k] = p[k];
}

// render/intersect.py barycentric_uv: the affine rows of the triangle,
// applied to (origin - v0) + t d.
FR_HD void barycentric_uv(const float* o, const float* d, float t, const float* v0,
                          const float* v1, const float* v2, float* u, float* v) {
  float e0[3], e1[3], ra[3], rb[3], e2[3];
  for (int k = 0; k < 3; ++k) {
    e0[k] = v2[k] - v0[k];
    e1[k] = v1[k] - v0[k];
  }
  const float d00 = dot3(e0, e0), d01 = dot3(e0, e1), d11 = dot3(e1, e1);
  const float inv_denom = 1.0f / (d00 * d11 - d01 * d01);
  for (int k = 0; k < 3; ++k) {
    ra[k] = (d11 * e0[k] - d01 * e1[k]) * inv_denom;
    rb[k] = (d00 * e1[k] - d01 * e0[k]) * inv_denom;
    e2[k] = (o[k] - v0[k]) + t * d[k];
  }
  *u = dot3(ra, e2);
  *v = dot3(rb, e2);
}

// render/intersect.py bary_interp over `width` lanes: w a0 + v a1 + u a2.
FR_HD void bary_interp(float u, float v, const float* a0, const float* a1, const float* a2,
                       int width, float* out) {
  const float w = 1.0f - u - v;
  for (int k = 0; k < width; ++k) out[k] = w * a0[k] + v * a1[k] + u * a2[k];
}

// The attributes of ray r (render/renderer.py hit_attributes_torch).
FR_HD void attributes(const AttrScene& s, const AttrRays& in, int64_t r, bool exact,
                      int normal_mode, const AttrOut& out) {
  const float t = in.t[r];
  const bool ok = t < kFltMax;
  const int32_t tri = in.tri[r] > 0 ? in.tri[r] : 0;
  const int32_t inst = in.inst[r] > 0 ? in.inst[r] : 0;
  const int32_t ri = s.num_instances == 1 ? 0 : inst;
  const float* pose = s.inst_pose + 6 * ri;
  const float* inv_pose = s.inst_inv_pose + 6 * ri;
  const float* scale = s.inst_scale + 3 * ri;
  const float* inv_scale = s.inst_inv_scale + 3 * ri;

  float q[4], wd[3], wo[3], od[3], oo[3];
  euler2quat(pose + 3, q);
  load3(in.dirs + 3 * r, wd);
  load3(in.origin + in.origin_stride * r, wo);
  quat_rot(q, wd, od);
  for (int k = 0; k < 3; ++k) wo[k] = wo[k] - pose[k];
  quat_rot(q, wo, oo);
  for (int k = 0; k < 3; ++k) {
    od[k] = od[k] * inv_scale[k];
    oo[k] = oo[k] * inv_scale[k];
  }

  const float* v0 = s.tri_v0 + 3 * tri;
  const float* v1 = s.tri_v1 + 3 * tri;
  const float* v2 = s.tri_v2 + 3 * tri;
  float point[3], tn[3], ub, vb;
  if (in.u != nullptr || in.n != nullptr) {
    // carried: the plane point from t (0 on a miss), n and or u, v as cast
    const float tp = ok ? t : 0.0f;
    for (int k = 0; k < 3; ++k) point[k] = oo[k] + tp * od[k];
    load3(in.n != nullptr ? in.n + 3 * r : s.tri_normal + 3 * tri, tn);
    if (in.u != nullptr) {
      ub = in.u[r];
      vb = in.v[r];
    } else {
      barycentric_uv(oo, od, tp, v0, v1, v2, &ub, &vb);
    }
  } else {
    // the redo: ray_plane_hit, then barycentric_uv at its t
    load3(s.tri_normal + 3 * tri, tn);
    const float denom = dot3(od, tn);
    const float safe = fabsf(denom) < kParallelEps ? 1.0f : denom;
    float rel[3];
    for (int k = 0; k < 3; ++k) rel[k] = v0[k] - oo[k];
    const float tp = dot3(rel, tn) / safe;
    for (int k = 0; k < 3; ++k) point[k] = oo[k] + tp * od[k];
    barycentric_uv(oo, od, tp, v0, v1, v2, &ub, &vb);
  }
  float uv[2];
  bary_interp(ub, vb, s.tri_uv0 + 2 * tri, s.tri_uv1 + 2 * tri, s.tri_uv2 + 2 * tri, 2, uv);
  if (s.tri_vnorm != nullptr) {
    const float* vr = s.tri_vnorm + 10 * tri;
    if (vr[9] > 0.0f && ok) bary_interp(ub, vb, vr, vr + 3, vr + 6, 3, tn);
  }

  float qi[4], ps[3], loc[3], nrm[3];
  euler2quat(inv_pose + 3, qi);
  for (int k = 0; k < 3; ++k) ps[k] = point[k] * scale[k] - inv_pose[k];
  quat_rot(qi, ps, loc);
  if (normal_mode == kInverseTranspose) {
    for (int k = 0; k < 3; ++k) ps[k] = tn[k] * inv_scale[k];
    quat_rot(qi, ps, nrm);
  } else {
    quat_rot(qi, tn, nrm);
    for (int k = 0; k < 3; ++k) nrm[k] = nrm[k] * scale[k];
  }
  normalize(nrm, exact);

  const int32_t tmat = s.tri_mat[tri];
  out.hit[r] = ok ? 1 : 0;
  for (int k = 0; k < 3; ++k) {
    out.location[3 * r + k] = loc[k];
    out.normal[3 * r + k] = nrm[k];
  }
  out.uv[2 * r] = uv[0];
  out.uv[2 * r + 1] = uv[1];
  out.material[r] = tmat >= 0 ? tmat : s.inst_material[ri];
  out.inst[r] = inst;
}

// ---------------------------------------------------------------------------
// S3 primary shade
// ---------------------------------------------------------------------------

constexpr float kInv2Pi = static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kLodEps = 1e-12f;   // render/shade.py: the footprint's floor
constexpr float kLightEps = 1e-8f;  // point lights: the distance's floor

// S3's texture filters (kernels/frame.py FILTERS).
enum Filter { kNearest = 0, kBilinear = 1, kTrilinear = 2 };

// The material and sky tables S3 reads; `textured` is
// SceneTensors.has_textures, `has_sky` its has_sky with the ray directions
// given (the sky map is sampled by direction).
struct ShadeScene {
  const float* mat_albedo;           // [K, 3]
  const int32_t* mat_tex_start;      // [K], -1 = untextured
  const int32_t* mat_tex_w;
  const int32_t* mat_tex_h;
  const int32_t* mat_tex_mip_start;  // [K, num_levels]
  int num_levels;
  const int32_t* tex_atlas;          // [P] r | g << 8 | b << 16
  int64_t atlas_size;
  int textured;
  const int32_t* sky_tex_start;      // [] (-1: the flat sky), read where has_sky
  const int32_t* sky_tex_w;
  const int32_t* sky_tex_h;
  int has_sky;
};

// The static shading config: mode, the light direction as given (has_light
// 0: light_direction None), exact maths, the Blinn-Phong lobe, the texture
// filter (trilinear takes its LOD from the screen derivatives of image rows
// [height, width], and with width 0 samples bilinear), the point lights and
// whether their shadow rays' answer is given.
struct ShadeParams {
  int mode;
  int has_light;
  float light[3];
  int exact;
  float specular;
  float shininess;
  int filter;
  int height;
  int width;
  int num_point_lights;
  int point_shadows;
};

// One ray's shading inputs. Each may be null where the config reads none of
// it: dirs (Blinn-Phong, the sky map), lit (Lambert with shadows: the shadow
// ray toward the light escaped), inst (trilinear's derivatives), location,
// point_lights and point_occ_t (point lights).
struct ShadeRays {
  const uint8_t* hit;
  const float* normal;       // [R, 3]
  const float* uv;           // [R, 2]
  const int64_t* material;
  const int64_t* inst;
  const float* location;     // [R, 3]
  const float* dirs;         // [R, 3]
  const uint8_t* lit;
  const float* point_lights;  // [L, 4]: position, intensity
  const float* point_occ_t;   // [L, R]: t of each light's shadow ray
  int64_t num_rays;
};

// torch.remainder on int32 (the sign of the divisor, b >= 1).
FR_HD int32_t py_rem(int32_t a, int32_t b) {
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 sums and products that wrap as PyTorch's do.
FR_HD int32_t add_w(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
FR_HD int32_t mul_w(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
FR_HD int32_t neg_wrap(int32_t a) { return static_cast<int32_t>(0u - static_cast<uint32_t>(a)); }

// render/shade.py _c_mod: C's truncating modulo of a by max(b, 1).
FR_HD int32_t c_mod(int32_t a, int32_t b) {
  b = b > 1 ? b : 1;
  return a >= 0 ? py_rem(a, b) : neg_wrap(py_rem(neg_wrap(a), b));
}

// render/shade.py _sample_texture_bilinear's wrap: ((i % n) + n) % n.
FR_HD int32_t pos_wrap(int32_t i, int32_t n) { return py_rem(add_w(py_rem(i, n), n), n); }

// torch.maximum and torch.minimum: NaN wins.
FR_HD float max_nan(float a, float b) { return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b); }
FR_HD float min_nan(float a, float b) { return (isnan(a) || isnan(b)) ? a + b : fminf(a, b); }

// render/shade.py _fetch_texel times TEXEL_SCALE: the atlas word at the
// clamped index, unpacked to f32 lanes.
FR_HD void fetch_texel(const ShadeScene& s, int32_t idx, float* out) {
  int64_t i = idx > 0 ? idx : 0;
  i = i > s.atlas_size - 1 ? s.atlas_size - 1 : i;
  const int32_t word = s.tex_atlas[i];
  for (int k = 0; k < 3; ++k) out[k] = static_cast<float>((word >> (8 * k)) & 0xFF);
}

// render/shade.py _sample_texture_vals, nearest: v flipped, the wrap
// clamped at 0, the texel scaled by TEXEL_SCALE.
FR_HD void sample_nearest(const ShadeScene& s, int32_t start, int32_t w, int32_t h, float u,
                          float v, float* out) {
  int32_t tx = static_cast<int32_t>(u * static_cast<float>(w));
  int32_t ty = static_cast<int32_t>((1.0f - v) * static_cast<float>(h));
  tx = c_mod(tx, w);
  ty = c_mod(ty, h);
  tx = tx > 0 ? tx : 0;
  ty = ty > 0 ? ty : 0;
  fetch_texel(s, add_w(add_w(start > 0 ? start : 0, mul_w(ty, w)), tx), out);
  for (int k = 0; k < 3; ++k) out[k] = out[k] * kTexelScale;
}

// render/shade.py _sample_texture_bilinear: texel centres at (i + 0.5) / w,
// v flipped, the four corners wrapped toroidally, two lerps.
FR_HD void sample_bilinear(const ShadeScene& s, int32_t start, int32_t w, int32_t h, float u,
                           float v, float* out) {
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = (1.0f - v) * static_cast<float>(h) - 0.5f;
  const int32_t x0 = static_cast<int32_t>(floorf(x));
  const int32_t y0 = static_cast<int32_t>(floorf(y));
  const float fx = x - static_cast<float>(x0);
  const float fy = y - static_cast<float>(y0);
  const int32_t wp = w > 1 ? w : 1, hp = h > 1 ? h : 1;
  const int32_t xw[2] = {pos_wrap(x0, wp), pos_wrap(add_w(x0, 1), wp)};
  const int32_t yw[2] = {pos_wrap(y0, hp), pos_wrap(add_w(y0, 1), hp)};
  const int32_t base = start > 0 ? start : 0;
  float c[2][2][3];  // [y][x]
  for (int j = 0; j < 2; ++j) {
    for (int i = 0; i < 2; ++i) fetch_texel(s, add_w(add_w(base, mul_w(yw[j], w)), xw[i]), c[j][i]);
  }
  for (int k = 0; k < 3; ++k) {
    const float top = c[0][0][k] + (c[0][1][k] - c[0][0][k]) * fx;
    const float bot = c[1][0][k] + (c[1][1][k] - c[1][0][k]) * fx;
    out[k] = (top + (bot - top) * fy) * kTexelScale;
  }
}

// render/shade.py uv_screen_derivatives along one image axis at ray r: the
// forward difference to `next`, else the backward one from `prev`, where
// the neighbour is the same surface (hit, material and instance), else 0.
FR_HD bool same_surface(const ShadeRays& in, int64_t a, int64_t b) {
  return in.hit[a] && in.hit[b] && in.material[a] == in.material[b] && in.inst[a] == in.inst[b];
}

FR_HD void uv_derivative(const ShadeRays& in, int64_t r, int64_t next, int64_t prev,
                         float* out) {
  const float* uv = in.uv;
  const bool fwd = same_surface(in, r, next), bwd = same_surface(in, r, prev);
  for (int k = 0; k < 2; ++k) {
    out[k] = fwd ? uv[2 * next + k] - uv[2 * r + k]
                 : (bwd ? uv[2 * r + k] - uv[2 * prev + k] : 0.0f);
  }
}

// render/shade.py _sample_texture_trilinear: the LOD from the larger
// texel-space footprint of the derivatives, bilinear taps on the two
// levels around it, and a lerp.
FR_HD void sample_trilinear(const ShadeScene& s, int64_t m, const float* uv, const float* ddx,
                            const float* ddy, float* out) {
  const int32_t w = s.mat_tex_w[m], h = s.mat_tex_h[m];
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const float fx0 = ddx[0] * wf, fx1 = ddx[1] * hf;
  const float fy0 = ddy[0] * wf, fy1 = ddy[1] * hf;
  const float rho2 = max_nan(fx0 * fx0 + fx1 * fx1, fy0 * fy0 + fy1 * fy1);
  const int top = s.num_levels - 1;
  const float lod = clamp_max(clamp_min(0.5f * log2f(clamp_min(rho2, kLodEps)), 0.0f),
                              static_cast<float>(top));
  const int32_t l0 = static_cast<int32_t>(lod);
  const int32_t l1 = l0 + 1 < top ? l0 + 1 : top;
  const float frac = lod - static_cast<float>(l0);
  float c[2][3];
  const int32_t lev[2] = {l0, l1};
  for (int j = 0; j < 2; ++j) {
    const int32_t start = s.mat_tex_mip_start[m * s.num_levels + lev[j]];
    const int32_t wl = (w >> lev[j]) > 1 ? (w >> lev[j]) : 1;
    const int32_t hl = (h >> lev[j]) > 1 ? (h >> lev[j]) : 1;
    sample_bilinear(s, start, wl, hl, uv[0], uv[1], c[j]);
  }
  for (int k = 0; k < 3; ++k) out[k] = c[0][k] + (c[1][k] - c[0][k]) * frac;
}

// render/shade.py surface_color at ray r: the texture sample where the
// material is textured, else its albedo.
FR_HD void surface_color(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in,
                         int64_t r, float* color) {
  const int64_t m = in.material[r];
  load3(s.mat_albedo + 3 * m, color);
  if (!s.textured || s.mat_tex_start[m] < 0) return;
  const int32_t start = s.mat_tex_start[m], w = s.mat_tex_w[m], h = s.mat_tex_h[m];
  const float* uv = in.uv + 2 * r;
  if (p.filter == kNearest) {
    sample_nearest(s, start, w, h, uv[0], uv[1], color);
  } else if (p.filter == kTrilinear && p.width > 0) {
    const int64_t W = p.width, H = p.height, x = r % W, y = r / W;
    float ddx[2], ddy[2];
    uv_derivative(in, r, y * W + (x + 1) % W, y * W + (x + W - 1) % W, ddx);
    uv_derivative(in, r, ((y + 1) % H) * W + x, ((y + H - 1) % H) * W + x, ddy);
    sample_trilinear(s, m, uv, ddx, ddy, color);
  } else {
    sample_bilinear(s, start, w, h, uv[0], uv[1], color);
  }
}

// render/shade.py SKY_COLOR, lane k.
FR_HD uint8_t sky(int k) { return k == 0 ? 255 : (k == 1 ? 204 : 153); }

// PyTorch's float -> uint8: through int64, wrapping.
FR_HD uint8_t to_u8(float x) { return static_cast<uint8_t>(static_cast<int64_t>(x)); }

// render/shade.py sky_radiance on the sky map: yaw about z from +y for u,
// 0 at the zenith for v clamped half a texel from the poles, one bilinear
// sample.
FR_HD void sky_map_radiance(const ShadeScene& s, const float* dir, bool exact, float* tex) {
  float d[3];
  load3(dir, d);
  normalize(d, exact);
  const float u = atan2f(d[0], d[1]) * kInv2Pi + 0.5f;
  const float z = clamp_max(clamp_min(d[2], -1.0f), 1.0f);
  float v = 1.0f - (0.5f - asinf(z) / kPi);
  const int32_t h = *s.sky_tex_h;
  const float half = 0.5f / static_cast<float>(h > 1 ? h : 1);
  v = min_nan(max_nan(v, half), 1.0f - half);
  sample_bilinear(s, *s.sky_tex_start, *s.sky_tex_w, h, u, v, tex);
}

// The sky map as u8 (render/shade.py shade_primary_torch).
FR_HD void sky_map(const ShadeScene& s, const float* dir, bool exact, uint8_t* out) {
  float tex[3];
  sky_map_radiance(s, dir, exact, tex);
  for (int k = 0; k < 3; ++k) out[k] = to_u8(tex[k] * 255.0f);
}

// render/shade.py point_light_illumination at ray r: per light the
// inverse-square falloff times the cosine, that cosine 0 where the light's
// shadow ray met an occluder nearer than the light.
FR_HD float point_light_illumination(const ShadeParams& p, const ShadeRays& in, int64_t r) {
  const float* loc = in.location + 3 * r;
  const float* n = in.normal + 3 * r;
  float illum = 0.0f;
  for (int j = 0; j < p.num_point_lights; ++j) {
    const float* light = in.point_lights + 4 * j;
    float to_light[3], ldir[3];
    for (int k = 0; k < 3; ++k) to_light[k] = light[k] - loc[k];
    const float dist = sqrtf(dot3(to_light, to_light));
    const float safe = clamp_min(dist, kLightEps);
    for (int k = 0; k < 3; ++k) ldir[k] = to_light[k] / safe;
    float cos_i = clamp_min(dot3(n, ldir), 0.0f);
    const float falloff = light[3] / clamp_min(dist * dist, kLightEps);
    if (p.point_shadows && !(in.point_occ_t[j * in.num_rays + r] >= dist)) cos_i = 0.0f;
    illum = illum + cos_i * falloff;
  }
  return illum;
}

// render/shade.py compute_illumination at ray r, clamped to [0.4, 1].
FR_HD float illumination(const ShadeParams& p, const ShadeRays& in, int64_t r) {
  if (p.mode == kFlat) return 1.0f;
  float illum = 0.0f;
  if (p.has_light) {
    float l[3] = {p.light[0], p.light[1], p.light[2]};
    normalize(l, p.exact);
    const float* n = in.normal + 3 * r;
    const float cos_illum = dot3(n, l);
    if (p.mode == kLambertShadow) {
      illum = in.lit[r] ? cos_illum : kShadowed * cos_illum;
    } else {
      illum = clamp_min(cos_illum, 0.0f);
      if (p.mode == kBlinnPhong) {
        float view[3], half[3];
        load3(in.dirs + 3 * r, view);
        normalize(view, p.exact);
        for (int k = 0; k < 3; ++k) half[k] = l[k] + -view[k];
        normalize(half, p.exact);
        const float spec = clamp_min(dot3(n, half), 0.0f);
        illum = illum + p.specular * powf(spec, p.shininess);
      }
    }
  }
  if (p.num_point_lights > 0) illum = illum + point_light_illumination(p, in, r);
  return clamp_min(clamp_max(illum, kIllumCeil), kIllumFloor);
}

// Whether the config has every input it reads.
FR_HD bool shade_args_ok(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in) {
  const bool lit = p.mode != kFlat && p.has_light;
  return in.num_rays > 0 && p.mode >= kFlat && p.mode <= kBlinnPhong && p.filter >= kNearest
         && p.filter <= kTrilinear && s.num_levels > 0
         && !(p.mode == kBlinnPhong && lit && in.dirs == nullptr)
         && !(p.mode == kLambertShadow && lit && in.lit == nullptr)
         && !(s.has_sky && (in.dirs == nullptr || s.sky_tex_start == nullptr))
         && !(p.filter == kTrilinear && p.width > 0
              && (in.inst == nullptr || static_cast<int64_t>(p.height) * p.width != in.num_rays))
         && !(p.num_point_lights > 0 && (in.location == nullptr || in.point_lights == nullptr))
         && !(p.point_shadows && p.num_point_lights > 0 && in.point_occ_t == nullptr);
}

// The colour of ray r (render/shade.py shade_primary_torch).
FR_HD void shade(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in, int64_t r,
                 uint8_t* out) {
  uint8_t* px = out + 3 * r;
  if (in.hit[r] == 0) {
    if (s.has_sky && *s.sky_tex_start >= 0) {
      sky_map(s, in.dirs + 3 * r, p.exact != 0, px);
    } else {
      for (int k = 0; k < 3; ++k) px[k] = sky(k);
    }
    return;
  }
  float color[3];
  surface_color(s, p, in, r, color);
  const float illum = illumination(p, in, r);
  for (int k = 0; k < 3; ++k) px[k] = to_u8(illum * color[k] * 255.0f);
}

// ---------------------------------------------------------------------------
// S4 sample
// ---------------------------------------------------------------------------

constexpr uint32_t kThreefryParity = 0x1BD11BDAu;  // utils/prng.py _PARITY
constexpr int kMaxChain = 4;                      // kernels/frame.py MAX_CHAIN
// 2.0 * math.pi as ATen rounds a Python scalar for an f32 tensor: the
// double, rounded once to f32
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

FR_HD uint32_t rotl32(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// utils/prng.py threefry2x32: counter words x1, x2 hashed in place under
// key words k1, k2; 5 groups of 4 rounds, a key injection after each.
FR_HD void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ kThreefryParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x1 += x2;
      x2 = rotl32(x2, kRot[g % 2][i]) ^ x1;
    }
    x1 += ks[(g + 1) % 3];
    x2 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// utils/prng.py fold_in(key, word), which is also split(key, n)[word]:
// the hash of the counter (0, word).
FR_HD void fold_in(uint32_t& k1, uint32_t& k2, uint32_t word) {
  uint32_t x1 = 0, x2 = word;
  threefry2x32(k1, k2, x1, x2);
  k1 = x1;
  k2 = x2;
}

// utils/prng.py uniform(key, shape) with minval 0, maxval 1 at the flat
// index idx: the bits b1 ^ b2 of the counter (idx >> 32, idx & 0xFFFFFFFF),
// their top 23 as the mantissa of a float in [1, 2), minus 1, times
// (1 - 0), plus 0, clamped below at 0 (torch.maximum: no NaN can arise).
FR_HD float uniform01(uint32_t k1, uint32_t k2, int64_t idx) {
  uint32_t x1 = static_cast<uint32_t>(static_cast<uint64_t>(idx) >> 32);
  uint32_t x2 = static_cast<uint32_t>(idx);
  threefry2x32(k1, k2, x1, x2);
  const uint32_t bits = ((x1 ^ x2) >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &bits, sizeof(f));
  const float v = (f - 1.0f) * 1.0f + 0.0f;
  return fmaxf(0.0f, v);
}

// render/integrators.py _cosine_sample of one ray: the direction around
// n [3] of the uniforms u0, u1, normalized (core/vecmath.py normalize).
// `-1.0 / x` is PyTorch's reciprocal times -1, which rounds as -1 / x.
FR_HD void cosine_sample(float u0, float u1, const float* n, bool exact, float* out) {
  const float r = sqrtf(u0);
  const float phi = u1 * kTwoPi;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(clamp_min(1.0f - u0, 0.0f));
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (sign + n[2]));
  const float b = n[0] * n[1] * a;
  const float t[3] = {1.0f + sign * (n[0] * n[0]) * a, sign * b, -sign * n[0]};
  const float bv[3] = {b, sign + (n[1] * n[1]) * a, -n[1]};
  for (int k = 0; k < 3; ++k) out[k] = (x * t[k] + y * bv[k]) + z * n[k];
  normalize(out, exact);
}

// The draw's key words: `key` [2] (uint32 values in int64) folded with
// chain[0], ..., chain[len - 1] into keys[0..1], and, where `lobe`, folded
// once more with `lobe_word` into keys[2..3] (the path tracer's lobe key).
struct SampleChain {
  int len;
  uint32_t word[kMaxChain];
  int lobe;
  uint32_t lobe_word;
};

FR_HD void sample_keys(const int64_t* key, const SampleChain& c, uint32_t* keys) {
  uint32_t k1 = static_cast<uint32_t>(key[0]), k2 = static_cast<uint32_t>(key[1]);
  for (int i = 0; i < c.len; ++i) fold_in(k1, k2, c.word[i]);
  keys[0] = k1;
  keys[1] = k2;
  if (c.lobe) fold_in(k1, k2, c.lobe_word);
  keys[2] = k1;
  keys[3] = k2;
}

// One draw over num_rays rays. The normals are read through their strides
// as [num_rays / inner, inner, 3] (an expanded batch has stride_outer 0);
// dirs [num_rays, 3] and lobe [num_rays] (null: not drawn) are contiguous.
struct SampleArgs {
  const float* normal;
  int64_t inner;
  int64_t stride_outer;
  int64_t stride_inner;
  int64_t stride_comp;
  int64_t num_rays;
  int exact;
  float* dirs;
  float* lobe;
};

// Ray r of the draw: uniforms 2r and 2r + 1 of shape + (2,) for the cosine
// sample, uniform r of shape for the lobe.
FR_HD void sample(const SampleArgs& a, const uint32_t* keys, int64_t r) {
  const float u0 = uniform01(keys[0], keys[1], 2 * r);
  const float u1 = uniform01(keys[0], keys[1], 2 * r + 1);
  const int64_t o = r / a.inner;
  const float* np = a.normal + o * a.stride_outer + (r - o * a.inner) * a.stride_inner;
  const float n[3] = {np[0], np[a.stride_comp], np[2 * a.stride_comp]};
  cosine_sample(u0, u1, n, a.exact != 0, a.dirs + 3 * r);
  if (a.lobe != nullptr) a.lobe[r] = uniform01(keys[2], keys[3], r);
}

FR_HD bool sample_args_ok(const SampleChain& c, const SampleArgs& a) {
  return c.len >= 0 && c.len <= kMaxChain && a.num_rays > 0 && a.inner > 0
         && a.num_rays % a.inner == 0 && a.normal != nullptr && a.dirs != nullptr;
}

// ---------------------------------------------------------------------------
// S5 Whitted shade
// ---------------------------------------------------------------------------

constexpr float kShadowEps = 1e-4f;   // render/shade.py SHADOW_EPS
constexpr float kParkOrigin = 1.0e9f;  // render/sorted_cast.py PARK_ORIGIN
constexpr float kParkDir = 1.0f;       // each lane of PARK_DIRECTION

// render/shade.py sky_radiance's flat sky, lane k: SKY_COLOR / 255.0 as
// ATen rounds a tensor over a Python scalar: on the card a multiply by the
// f32 reciprocal, on the host an IEEE divide (lane 1 differs by an ulp).
FR_HD float flat_sky(int k) {
  const float c = static_cast<float>(sky(k));
#if defined(__CUDA_ARCH__)
  return c * (1.0f / 255.0f);
#else
  return c / 255.0f;
#endif
}

// One bounce's light term and state, beside its rays and hit attributes
// (ShadeRays: dirs, hit, location, normal, uv, material). `radiance`,
// `throughput` [R, 3] and `active` are read (but at the first bounce,
// which starts from 0, 1 and true) and written in place; `origin_out` and
// `dirs_out` [R, 3] take the next bounce's rays, and are not written at
// the last bounce.
struct WhittedState {
  const float* illum;             // [R] the light stage's term, unclamped
  const float* mat_reflectivity;  // [K]
  const float* mat_illumination;  // [K]
  float* radiance;
  float* throughput;
  uint8_t* active;
  float* origin_out;
  float* dirs_out;
  int first;
  int last;
};

// Bounce r of render/integrators.py whitted_shade_torch. `p` holds exact
// and the texture filter with width 0 (trilinear samples bilinear). A
// lane's `x + where(c, y, 0)` is `x + (c ? y : 0)`, so a -0 sum rounds as
// PyTorch's does.
FR_HD void whitted_shade(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in,
                         const WhittedState& w, int64_t r) {
  const bool hit = in.hit[r] != 0;
  const bool active = w.first || w.active[r] != 0;
  float rad[3], thr[3];
  for (int k = 0; k < 3; ++k) {
    rad[k] = w.first ? 0.0f : w.radiance[3 * r + k];
    thr[k] = w.first ? 1.0f : w.throughput[3 * r + k];
  }
  const bool miss = active && !hit;
  float sky_rgb[3] = {0.0f, 0.0f, 0.0f};
  if (miss) {
    if (s.has_sky && *s.sky_tex_start >= 0) {
      sky_map_radiance(s, in.dirs + 3 * r, p.exact != 0, sky_rgb);
    } else {
      for (int k = 0; k < 3; ++k) sky_rgb[k] = flat_sky(k);
    }
  }
  for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (miss ? thr[k] * sky_rgb[k] : 0.0f);

  const bool live = active && hit;
  float color[3] = {0.0f, 0.0f, 0.0f}, local[3] = {0.0f, 0.0f, 0.0f}, refl = 0.0f;
  if (live) {
    surface_color(s, p, in, r, color);
    const int64_t m = in.material[r];
    refl = w.mat_reflectivity[m];
    const float emit = w.mat_illumination[m];
    const float illum = clamp_max(clamp_min(w.illum[r], kIllumFloor), kIllumCeil);
    for (int k = 0; k < 3; ++k) local[k] = color[k] * illum * (1.0f - refl) + emit;
  }
  for (int k = 0; k < 3; ++k) {
    rad[k] = rad[k] + (live ? thr[k] * local[k] : 0.0f);
    w.radiance[3 * r + k] = rad[k];
  }
  if (w.last) {
    if (w.first) {
      for (int k = 0; k < 3; ++k) w.throughput[3 * r + k] = thr[k];
      w.active[r] = 1;
    }
    return;
  }

  for (int k = 0; k < 3; ++k) {
    w.throughput[3 * r + k] = thr[k] * (live ? color[k] * refl : 0.0f);
  }
  const bool next = live && refl > 0.0f;
  w.active[r] = next ? 1 : 0;
  float* o = w.origin_out + 3 * r;
  float* d = w.dirs_out + 3 * r;
  if (!next) {
    for (int k = 0; k < 3; ++k) {
      o[k] = kParkOrigin;
      d[k] = kParkDir;
    }
    return;
  }
  float dir[3], n[3], loc[3], out[3];
  load3(in.dirs + 3 * r, dir);
  load3(in.normal + 3 * r, n);
  load3(in.location + 3 * r, loc);
  const float twice = 2.0f * dot3(dir, n);
  for (int k = 0; k < 3; ++k) out[k] = dir[k] - twice * n[k];
  normalize(out, p.exact != 0);
  for (int k = 0; k < 3; ++k) {
    o[k] = loc[k] + out[k] * kShadowEps;
    d[k] = out[k];
  }
}

FR_HD bool whitted_args_ok(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in,
                           const WhittedState& w) {
  return in.num_rays > 0 && p.filter >= kNearest && p.filter <= kTrilinear && p.width == 0
         && s.num_levels > 0 && !(s.has_sky && s.sky_tex_start == nullptr)
         && in.dirs != nullptr && in.hit != nullptr && in.material != nullptr
         && in.uv != nullptr && w.illum != nullptr && w.radiance != nullptr
         && w.throughput != nullptr && w.active != nullptr
         && (w.last || (w.origin_out != nullptr && w.dirs_out != nullptr
                        && in.location != nullptr && in.normal != nullptr));
}

// ---------------------------------------------------------------------------
// S6 path bounce
// ---------------------------------------------------------------------------

// One path-tracing bounce's inputs beside its rays and hit attributes
// (ShadeRays: dirs, hit, location, normal, uv, material; null in the tail
// but dirs), and its state. Ray r reads the rows of ShadeRays at row
// r % period: the batched wavefront's first bounce hands the primary rows
// once for every sample (period = the rays of one sample), every other
// bounce per ray (period = num_rays). The per-ray inputs and the state are
// read at r.
// `radiance`, `throughput` [R, 3] and `active` are read (but at the first
// bounce, which starts from 0, 1 and true) and written in place; the tail
// writes the radiance alone (and at a first bounce the rest of the state),
// a bounce also `origin_out` and `dirs_out` [R, 3].
struct PathBounce {
  const float* mat_reflectivity;  // [K]
  const float* mat_illumination;  // [K]
  const float* mat_roughness;     // [K]
  const float* t;                 // [R] the tail's any-hit t (tail only)
  const float* d_diff;            // [R, 3] S4's cosine samples (a bounce)
  const float* lobe;              // [R] S4's lobe uniforms (a bounce)
  const float* illum;             // [R] NEE's light term, or null: NEE off
  int64_t period;
  float sky_strength;
  float light_scale;              // 1 / pi times the sun's intensity
  float* radiance;
  float* throughput;
  uint8_t* active;
  float* origin_out;
  float* dirs_out;
  int first;
  int tail;
};

// Bounce r of render/integrators.py path_bounce_torch, whose rows are row q
// (r % period). `p` holds exact and the texture filter with width 0
// (trilinear samples bilinear). A lane's `x + where(c, y, 0)` is
// `x + (c ? y : 0)` and `x * where(c, y, 1)` is `x * (c ? y : 1)`, so each
// rounds as PyTorch's does.
FR_HD void path_bounce(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in,
                       const PathBounce& b, int64_t r, int64_t q) {
  const bool active = b.first || b.active[r] != 0;
  float rad[3], thr[3];
  for (int k = 0; k < 3; ++k) {
    rad[k] = b.first ? 0.0f : b.radiance[3 * r + k];
    thr[k] = b.first ? 1.0f : b.throughput[3 * r + k];
  }
  // the tail's answer is the any-hit t: a miss where t >= FLT_MAX
  const bool hit = b.tail ? !(b.t[r] >= kFltMax) : in.hit[q] != 0;
  const bool miss = active && !hit;
  float sky_rgb[3] = {0.0f, 0.0f, 0.0f};
  if (miss) {
    if (s.has_sky && *s.sky_tex_start >= 0) {
      sky_map_radiance(s, in.dirs + 3 * q, p.exact != 0, sky_rgb);
    } else {
      for (int k = 0; k < 3; ++k) sky_rgb[k] = flat_sky(k);
    }
    for (int k = 0; k < 3; ++k) sky_rgb[k] = sky_rgb[k] * b.sky_strength;
  }
  for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (miss ? thr[k] * sky_rgb[k] : 0.0f);
  if (b.tail) {
    for (int k = 0; k < 3; ++k) b.radiance[3 * r + k] = rad[k];
    if (b.first) {
      for (int k = 0; k < 3; ++k) b.throughput[3 * r + k] = thr[k];
      b.active[r] = 1;
    }
    return;
  }

  const bool live = active && hit;
  float color[3] = {1.0f, 1.0f, 1.0f}, emit = 0.0f, refl = 0.0f, rough = 0.0f;
  if (live) {
    surface_color(s, p, in, q, color);
    const int64_t m = in.material[q];
    emit = b.mat_illumination[m];
    refl = b.mat_reflectivity[m];
    rough = b.mat_roughness[m];
  }
  for (int k = 0; k < 3; ++k) {
    rad[k] = rad[k] + (live ? thr[k] * emit : 0.0f);
    thr[k] = thr[k] * (live ? color[k] : 1.0f);
  }
  if (b.illum != nullptr) {
    // the light's term on the diffuse part of the lobe mix
    const float wgt = (1.0f - refl) * b.illum[r] * b.light_scale;
    for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (live ? thr[k] * wgt : 0.0f);
  }
  for (int k = 0; k < 3; ++k) {
    b.radiance[3 * r + k] = rad[k];
    b.throughput[3 * r + k] = thr[k];
  }
  b.active[r] = live ? 1 : 0;
  float* o = b.origin_out + 3 * r;
  float* d = b.dirs_out + 3 * r;
  if (!live) {
    for (int k = 0; k < 3; ++k) {
      o[k] = kParkOrigin;
      d[k] = kParkDir;
    }
    return;
  }
  // the glossy lobe: the mirror blended toward the cosine sample by the
  // roughness, back to the cosine sample where it dips under the surface
  float dir[3], n[3], diff[3], spec[3];
  load3(in.dirs + 3 * q, dir);
  load3(in.normal + 3 * q, n);
  load3(b.d_diff + 3 * r, diff);
  const float twice = 2.0f * dot3(dir, n);
  const float keep = 1.0f - rough;
  for (int k = 0; k < 3; ++k) spec[k] = keep * (dir[k] - twice * n[k]) + rough * diff[k];
  normalize(spec, p.exact != 0);
  const bool glossy = b.lobe[r] < refl;
  const float* next = glossy && dot3(spec, n) > 0.0f ? spec : diff;
  const float* loc = in.location + 3 * q;
  for (int k = 0; k < 3; ++k) {
    o[k] = loc[k] + next[k] * kShadowEps;
    d[k] = next[k];
  }
}

FR_HD bool path_args_ok(const ShadeScene& s, const ShadeParams& p, const ShadeRays& in,
                        const PathBounce& b) {
  const bool rows = b.tail ? b.t != nullptr
                           : in.hit != nullptr && in.location != nullptr && in.normal != nullptr
                                 && in.uv != nullptr && in.material != nullptr
                                 && b.d_diff != nullptr && b.lobe != nullptr
                                 && b.origin_out != nullptr && b.dirs_out != nullptr;
  return in.num_rays > 0 && b.period > 0 && in.num_rays % b.period == 0 && p.filter >= kNearest
         && p.filter <= kTrilinear && p.width == 0 && s.num_levels > 0
         && !(s.has_sky && s.sky_tex_start == nullptr) && in.dirs != nullptr && rows
         && b.radiance != nullptr && b.throughput != nullptr && b.active != nullptr;
}

}  // namespace fr
