"""Primary-hit shading: flat, Lambert, Lambert with hard shadows and
Blinn-Phong under a directional light and point lights, texture filters
and the environment-map sky.

Counterpart of ``tpu_raytracer/render/shade.py``: misses take the sky
colour (255, 204, 153), or the scene's equirect sky map where it has one
(``Scene.set_sky``); textured materials sample nearest-neighbour with v
flipped and a C-style truncating modulo wrap clamped at 0, scaled by the
literal 0.0039215, or bilinear (texel centres, positive wrap), or
trilinear over the packed mip chains with the LOD from screen-space uv
derivatives; untextured ones take their albedo; illumination ends
clamped to [0.4, 1]; the u8 cast truncates. ``lambert_shadow`` casts one
any-hit shadow ray per lit hit toward the light, and one distance-bounded
nearest-hit ray per point light. ``shade_primary`` routes: kernel S3 on
the card, ``shade_primary_torch`` (its plain version) on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..core.vecmath import FLT_MAX, constant, dot, normalize
from .renderer import get_cast_fn

SKY_COLOR = (255, 204, 153)
SHADOW_EPS = 1e-4  # shadow/bounce origin offset along the new direction
DEFAULT_LIGHT_DIRECTION = (-0.2, 0.0, 1.0)
# Blinn-Phong lobe (BASELINE config 3); the reference has no specular term
BLINN_SHININESS = 32.0
BLINN_SPECULAR = 0.5
TEXTURE_FILTERS = ("nearest", "bilinear", "trilinear")
TEXEL_SCALE = 0.0039215  # the reference's literal 1/255


def point_light_vector(attrs, light) -> tuple:
    """(distance [...], unit direction [..., 3]) from each hit point
    toward the point light ``light``."""
    lpos = constant(light.position, torch.float32, attrs.t.device)
    to_light = lpos - attrs.location
    dist = torch.sqrt(dot(to_light, to_light))
    return dist, to_light / torch.clamp(dist, min=1e-8)[..., None]


def point_shadow_t(scene, attrs, ldir, cast) -> torch.Tensor:
    """t of the nearest-hit shadow ray (``cast``) from each hit point
    along the unit ``ldir`` toward a point light; rays whose primary
    missed are parked."""
    from .sorted_cast import park_dead_rays

    return cast(scene, *park_dead_rays(attrs.location + ldir * SHADOW_EPS, ldir, attrs.hit)).t


def point_shadow_cast(mode: str, backend: str = "cuda", cast_fn=None, nearest_cast_fn=None):
    """The cast of the point lights' shadow rays: None (no shadows) but
    in ``lambert_shadow``, there ``nearest_cast_fn`` or the backend's
    nearest cast, sorted as its secondary casts are. A ``cast_fn``
    override needs ``nearest_cast_fn`` beside it."""
    if cast_fn is not None and nearest_cast_fn is None:
        raise ValueError("point lights with a cast_fn override also need nearest_cast_fn: "
                         "their shadows are distance-bounded, which the any-hit cast "
                         "cannot answer")
    if mode != "lambert_shadow":
        return None
    if nearest_cast_fn is not None:
        return nearest_cast_fn
    from .sorted_cast import secondary_cast_fn

    return secondary_cast_fn(get_cast_fn(backend), backend)


def point_light_illumination(scene, attrs, point_lights, cast=None) -> torch.Tensor:
    """Summed point-light term at the hit points: inverse-square falloff
    times the cosine, and, where ``cast`` is given, a hard shadow per
    light from a nearest-hit ray that counts only occluders nearer than
    the light."""
    illum = torch.zeros(attrs.t.shape, dtype=torch.float32, device=attrs.t.device)
    for light in point_lights:
        dist, ldir = point_light_vector(attrs, light)
        cos_i = torch.clamp(dot(attrs.normal, ldir), min=0.0)
        # a tensor numerator: PyTorch takes ``scalar / x`` as the scalar
        # times 1 / x, which rounds twice
        falloff = torch.full_like(dist, light.intensity) / torch.clamp(dist * dist, min=1e-8)
        if cast is not None:
            occ_t = point_shadow_t(scene, attrs, ldir, cast)
            cos_i = torch.where(occ_t >= dist, cos_i, torch.zeros_like(cos_i))
        illum = illum + cos_i * falloff
    return illum


def _c_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C-style truncating integer modulo (a negative stays negative)."""
    b = torch.clamp(b, min=1)
    return torch.where(a >= 0, a % b, -((-a) % b))


def _fetch_texel(scene, idx: torch.Tensor) -> torch.Tensor:
    """Unpack ``r | g << 8 | b << 16`` atlas words to [..., 3] f32."""
    word = scene.tex_atlas[torch.clamp(idx, 0, scene.tex_atlas.shape[0] - 1).long()]
    return torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                       dim=-1).to(torch.float32)


def sample_texture(scene, material: torch.Tensor, uv: torch.Tensor,
                   tex_filter: str = "nearest") -> torch.Tensor:
    """Texel colour [..., 3] in [0, 1] of material ids ``material`` at
    ``uv``, nearest (the reference's wrap) or bilinear; untextured
    materials read the atlas from 0 (callers mask them, as
    ``surface_color`` does)."""
    m = material.long()
    return _sample_texture_vals(scene, scene.mat_tex_start[m], scene.mat_tex_w[m],
                                scene.mat_tex_h[m], uv, tex_filter)


def _sample_texture_vals(scene, start, w, h, uv, tex_filter: str = "nearest") -> torch.Tensor:
    """Texel colour [..., 3] in [0, 1] of textures at atlas ``start`` of
    ``w`` x ``h`` texels, nearest (the reference's wrap) or bilinear."""
    if tex_filter == "bilinear":
        return _sample_texture_bilinear(scene, start, w, h, uv)
    if tex_filter != "nearest":
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    tex_x = (uv[..., 0] * w.to(torch.float32)).to(torch.int32)
    tex_y = ((1.0 - uv[..., 1]) * h.to(torch.float32)).to(torch.int32)
    tex_x = torch.clamp(_c_mod(tex_x, w), min=0)
    tex_y = torch.clamp(_c_mod(tex_y, h), min=0)
    idx = torch.clamp(start, min=0) + tex_y * w + tex_x
    return _fetch_texel(scene, idx) * TEXEL_SCALE


def _sample_texture_bilinear(scene, start, w, h, uv) -> torch.Tensor:
    """Bilinear filter over the packed atlas: 4 corner texels and two
    lerps. Texel centres sit at (i + 0.5) / w, v flipped as in the
    nearest path; corners wrap toroidally (positive modulo)."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = uv[..., 0] * wf - 0.5
    y = (1.0 - uv[..., 1]) * hf - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    wp = torch.clamp(w, min=1)
    hp = torch.clamp(h, min=1)
    wrap = lambda i, n: ((i % n) + n) % n
    xw = (wrap(x0, wp), wrap(x0 + 1, wp))
    yw = (wrap(y0, hp), wrap(y0 + 1, hp))
    base = torch.clamp(start, min=0)
    c00 = _fetch_texel(scene, base + yw[0] * w + xw[0])
    c10 = _fetch_texel(scene, base + yw[0] * w + xw[1])
    c01 = _fetch_texel(scene, base + yw[1] * w + xw[0])
    c11 = _fetch_texel(scene, base + yw[1] * w + xw[1])
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return (top + (bot - top) * fy) * TEXEL_SCALE


def uv_screen_derivatives(attrs) -> tuple:
    """Per-pixel uv screen derivatives (d/dx, d/dy) of image-shaped
    attributes ([H, W]) for the mip LOD: forward differences, the
    backward one where the +1 neighbour is another surface (other
    material or instance, or a miss), else 0 (the sharpest level)."""
    uv = attrs.uv
    same = lambda a, sh, ax: torch.roll(a, sh, dims=ax)

    def valid_with(sh, ax):
        return (attrs.hit & same(attrs.hit, sh, ax)
                & (attrs.material == same(attrs.material, sh, ax))
                & (attrs.inst == same(attrs.inst, sh, ax)))

    def axis_diff(ax):
        fwd = same(uv, -1, ax) - uv
        bwd = uv - same(uv, 1, ax)
        okf = valid_with(-1, ax)[..., None]
        okb = valid_with(1, ax)[..., None]
        return torch.where(okf, fwd, torch.where(okb, bwd, torch.zeros_like(uv)))

    return axis_diff(1), axis_diff(0)


def _sample_texture_trilinear(scene, mat, uv, duv_dx, duv_dy) -> torch.Tensor:
    """Mip-mapped trilinear sample: the LOD from the larger texel-space
    footprint of the screen derivatives, bilinear taps on the two levels
    around it (``mat_tex_mip_start``), and a lerp between them."""
    w = scene.mat_tex_w[mat]
    h = scene.mat_tex_h[mat]
    wh = torch.stack([w, h], dim=-1).to(torch.float32)
    fx = duv_dx * wh
    fy = duv_dy * wh
    rho2 = torch.maximum((fx * fx).sum(-1), (fy * fy).sum(-1))
    n_levels = scene.mat_tex_mip_start.shape[1]
    lod = torch.clamp(0.5 * torch.log2(torch.clamp(rho2, min=1e-12)), 0.0,
                      float(n_levels - 1))
    l0 = lod.to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    frac = (lod - l0.to(torch.float32))[..., None]
    flat_starts = scene.mat_tex_mip_start.reshape(-1)

    def level_tap(lev):
        start = flat_starts[(mat * n_levels + lev).long()]
        wl = torch.clamp(w >> lev, min=1)
        hl = torch.clamp(h >> lev, min=1)
        return _sample_texture_bilinear(scene, start, wl, hl, uv)

    c0 = level_tap(l0)
    c1 = level_tap(l1)
    return c0 + (c1 - c0) * frac


def surface_color(scene, attrs, tex_filter: str = "nearest", uv_ddx=None,
                  uv_ddy=None) -> torch.Tensor:
    """The texture sample where the material is textured, else its
    albedo. ``trilinear`` needs the screen-space uv derivatives
    (``uv_screen_derivatives``); without them (secondary rays) it
    samples bilinear."""
    if tex_filter not in TEXTURE_FILTERS:
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    alb = scene.mat_albedo[attrs.material]
    if not scene.has_textures:
        return alb
    start = scene.mat_tex_start[attrs.material]
    w = scene.mat_tex_w[attrs.material]
    h = scene.mat_tex_h[attrs.material]
    if tex_filter == "trilinear" and uv_ddx is not None:
        tex = _sample_texture_trilinear(scene, attrs.material, attrs.uv, uv_ddx, uv_ddy)
    else:
        tex = _sample_texture_vals(scene, start, w, h, attrs.uv,
                                   "bilinear" if tex_filter == "trilinear" else tex_filter)
    return torch.where((start >= 0)[..., None], tex, alb)


def sky_radiance(scene, directions: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Per-ray sky radiance [..., 3] f32 in [0, 1]: the scene's equirect
    sky map (``Scene.set_sky``) sampled bilinear by direction where it
    has one, else the reference's flat constant. World is y-forward,
    z-up: u is the yaw about z from +y, v is 0 at the zenith."""
    dev = directions.device
    flat = constant(SKY_COLOR, torch.float32, dev) / 255.0
    flat = flat.expand(directions.shape[:-1] + (3,))
    if not scene.has_sky:
        return flat
    d = normalize(torch.as_tensor(directions, dtype=torch.float32), exact=exact)
    u = torch.atan2(d[..., 0], d[..., 1]) * (1.0 / (2.0 * math.pi)) + 0.5
    # tensor operands of the divisions: PyTorch may take a Python scalar
    # divisor or numerator through its reciprocal, which rounds twice
    pi = torch.full_like(d[..., 2], math.pi)
    v = 1.0 - (0.5 - torch.asin(torch.clamp(d[..., 2], -1.0, 1.0)) / pi)
    hf = torch.clamp(scene.sky_tex_h, min=1).to(torch.float32)
    half = torch.full_like(hf, 0.5) / hf
    # no wrap at the poles (the bilinear path flips v again)
    v = torch.minimum(torch.maximum(v, half), 1.0 - half)
    tex = _sample_texture_bilinear(scene, scene.sky_tex_start, scene.sky_tex_w,
                                   scene.sky_tex_h, torch.stack([u, v], -1))
    return torch.where(scene.sky_tex_start >= 0, tex, flat)


def light_vector(light_direction, device, exact: bool = True) -> torch.Tensor:
    """The unit vector toward the directional light."""
    return normalize(constant(light_direction, torch.float32, device), exact=exact)


def shadow_lit(scene, attrs, light_dir, cos_illum, point_lights: tuple = (),
               backend: str = "cuda", cast_fn=None):
    """Where the shadow ray from each hit toward the light (unit
    ``light_dir`` [3], ``cos_illum`` the cosine to it) escapes: one any-hit
    cast (``cast_fn``, default the backend's). Shadow rays go only where
    the primary hit and, without point lights, where the cosine is above
    0.4: below it the final clamp maps lit (cos) and shadowed (0.4 cos) to
    the same 0.4, so the answer cannot show. The other rays are parked,
    so they miss and read as lit."""
    from .renderer import occlusion_cast_fn
    from .sorted_cast import park_dead_rays

    need = attrs.hit
    if not point_lights:
        need = need & (cos_illum > 0.4)
    cast = cast_fn if cast_fn is not None else occlusion_cast_fn(backend)
    occ = cast(scene, *park_dead_rays(attrs.location + light_dir * SHADOW_EPS,
                                      light_dir.expand(attrs.location.shape), need))
    return occ.t >= FLT_MAX


def compute_illumination(scene, attrs, light_direction, mode: str, exact: bool = True,
                         backend: str = "cuda", directions=None, point_lights: tuple = (),
                         cast_fn=None, nearest_cast_fn=None) -> torch.Tensor:
    """Scalar illumination per ray.

    ``flat``: 1 (the reference's active path). ``lambert``: the cosine
    to the light. ``lambert_shadow``: the cosine where a shadow ray
    toward the light escapes, else 0.4 times it. ``blinn_phong``: the
    cosine plus a half-vector specular lobe (needs ``directions``, the
    primary ray directions). ``point_lights`` (``integrators.PointLight``)
    add their inverse-square terms in every mode but ``flat``, shadowed
    in ``lambert_shadow`` by a distance-bounded nearest-hit cast
    (``nearest_cast_fn``, default the backend's nearest cast, sorted as
    its secondary casts are). Every mode ends clamped to [0.4, 1];
    ``light_direction=None`` drops the directional light. ``cast_fn``
    replaces the directional shadow cast (default: the backend's any-hit
    cast); with point lights it needs ``nearest_cast_fn`` beside it."""
    shape, dev = attrs.t.shape, attrs.t.device
    if mode == "flat":
        illum = torch.ones(shape, dtype=torch.float32, device=dev)
    elif light_direction is None:
        illum = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        light_dir = light_vector(light_direction, dev, exact)
        cos_illum = dot(attrs.normal, light_dir)
        illum = torch.clamp(cos_illum, min=0.0)
        if mode == "blinn_phong":
            if directions is None:
                raise ValueError("blinn_phong needs the ray directions")
            view = -normalize(directions, exact=exact)
            half = normalize(light_dir + view, exact=exact)
            spec = torch.clamp(dot(attrs.normal, half), min=0.0)
            illum = illum + BLINN_SPECULAR * spec ** BLINN_SHININESS
        elif mode == "lambert_shadow":
            lit = shadow_lit(scene, attrs, light_dir, cos_illum, point_lights, backend, cast_fn)
            illum = torch.where(lit, cos_illum, 0.4 * cos_illum)
        elif mode != "lambert":
            raise ValueError(f"unknown lighting mode: {mode}")
    if point_lights and mode != "flat":
        pcast = point_shadow_cast(mode, backend, cast_fn, nearest_cast_fn)
        illum = illum + point_light_illumination(scene, attrs, point_lights, cast=pcast)
    illum = torch.clamp(illum, max=1.0)
    return torch.clamp(illum, min=0.4)


def shade_primary(scene, attrs, light_direction=DEFAULT_LIGHT_DIRECTION, mode: str = "flat",
                  exact: bool = True, backend: str = "cuda", directions=None,
                  point_lights: tuple = (), tex_filter: str = "nearest", cast_fn=None,
                  nearest_cast_fn=None) -> torch.Tensor:
    """Primary-hit shade -> uint8 [..., 3] (``shade_primary_torch`` says
    how). CUDA tensors launch kernel S3 (``kernels/frame.py
    shade_primary_cuda``) on every config; for Lambert with shadows the
    shadow rays toward the light and the point lights are cast first
    (``shadow_answers``) and S3 reads their answers. CPU
    tensors take the plain version ``shade_primary_torch``."""
    from ..kernels import frame

    if attrs.hit.device.type == "cpu":
        return shade_primary_torch(scene, attrs, light_direction, mode, exact, backend,
                                   directions, point_lights, tex_filter, cast_fn,
                                   nearest_cast_fn)
    lit, occ_t = shadow_answers(scene, attrs, light_direction, mode, exact, backend,
                                point_lights, cast_fn, nearest_cast_fn)
    return frame.shade_primary_cuda(scene, attrs, light_direction, mode, exact, directions, lit,
                                    point_lights, occ_t, tex_filter)


def shadow_answers(scene, attrs, light_direction=DEFAULT_LIGHT_DIRECTION, mode: str = "flat",
                   exact: bool = True, backend: str = "cuda", point_lights: tuple = (),
                   cast_fn=None, nearest_cast_fn=None) -> tuple:
    """The shadow rays' answers kernel S3 reads, cast as
    ``compute_illumination`` casts them: (``lit`` [...] bool, where the
    ray toward the directional light escaped, or None; ``occ_t`` [L, ...]
    f32, the t of each point light's shadow ray, or None). Only
    ``lambert_shadow`` casts."""
    lit = occ_t = None
    if mode == "lambert_shadow" and light_direction is not None:
        light_dir = light_vector(light_direction, attrs.hit.device, exact)
        lit = shadow_lit(scene, attrs, light_dir, dot(attrs.normal, light_dir), point_lights,
                         backend, cast_fn)
    if point_lights and mode != "flat":
        pcast = point_shadow_cast(mode, backend, cast_fn, nearest_cast_fn)
        if pcast is not None:
            occ_t = torch.stack([point_shadow_t(scene, attrs, point_light_vector(attrs, pl)[1],
                                                pcast) for pl in point_lights])
    return lit, occ_t


def shade_primary_torch(scene, attrs, light_direction=DEFAULT_LIGHT_DIRECTION,
                        mode: str = "flat", exact: bool = True, backend: str = "cuda",
                        directions=None, point_lights: tuple = (), tex_filter: str = "nearest",
                        cast_fn=None, nearest_cast_fn=None) -> torch.Tensor:
    """Primary-hit shade -> uint8 [..., 3] in the reference's channel
    order; misses take the sky colour, or the sky map where the scene
    has one and ``directions`` are given. The plain version of
    ``shade_primary`` (and of kernel S3)."""
    ddx = ddy = None
    if tex_filter == "trilinear" and attrs.uv.dim() == 3:
        ddx, ddy = uv_screen_derivatives(attrs)
    color = surface_color(scene, attrs, tex_filter, ddx, ddy)
    illum = compute_illumination(
        scene, attrs, light_direction, mode, exact=exact, backend=backend,
        directions=directions, point_lights=point_lights, cast_fn=cast_fn,
        nearest_cast_fn=nearest_cast_fn)
    rgb = illum[..., None] * color * 255.0
    shaded = rgb.to(torch.uint8)  # truncates like the C cast
    sky = constant(SKY_COLOR, torch.uint8, shaded.device)
    if directions is not None and scene.has_sky:
        tex = (sky_radiance(scene, directions, exact=exact) * 255.0).to(torch.uint8)
        sky = torch.where(scene.sky_tex_start >= 0, tex, sky)
    return torch.where(attrs.hit[..., None], shaded, sky)
