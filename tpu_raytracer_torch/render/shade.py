"""Primary-hit shading: flat, Lambert, Lambert with hard shadows and
Blinn-Phong under one directional light.

Counterpart of ``tpu_raytracer/render/shade.py``: misses take the sky
colour (255, 204, 153); textured materials sample nearest-neighbour with
v flipped and a C-style truncating modulo wrap clamped at 0, scaled by
the literal 0.0039215; untextured ones take their albedo; illumination
ends clamped to [0.4, 1]; the u8 cast truncates. ``lambert_shadow``
casts one any-hit shadow ray per lit hit toward the light. Point
lights (ROADMAP item 8), filtered textures and sky maps (item 9) are
not ported yet.
"""

from __future__ import annotations

import torch

from ..core.vecmath import FLT_MAX, dot, normalize

SKY_COLOR = (255, 204, 153)
SHADOW_EPS = 1e-4  # shadow/bounce origin offset along the new direction
DEFAULT_LIGHT_DIRECTION = (-0.2, 0.0, 1.0)
# Blinn-Phong lobe (BASELINE config 3); the reference has no specular term
BLINN_SHININESS = 32.0
BLINN_SPECULAR = 0.5


def _c_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C-style truncating integer modulo (a negative stays negative)."""
    b = torch.clamp(b, min=1)
    return torch.where(a >= 0, a % b, -((-a) % b))


def _fetch_texel(scene, idx: torch.Tensor) -> torch.Tensor:
    """Unpack ``r | g << 8 | b << 16`` atlas words to [..., 3] f32."""
    word = scene.tex_atlas[torch.clamp(idx, 0, scene.tex_atlas.shape[0] - 1)]
    return torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                       dim=-1).to(torch.float32)


def _sample_texture_nearest(scene, start, w, h, uv) -> torch.Tensor:
    tex_x = (uv[..., 0] * w.to(torch.float32)).to(torch.int32)
    tex_y = ((1.0 - uv[..., 1]) * h.to(torch.float32)).to(torch.int32)
    tex_x = torch.clamp(_c_mod(tex_x, w), min=0)
    tex_y = torch.clamp(_c_mod(tex_y, h), min=0)
    idx = torch.clamp(start, min=0) + tex_y * w + tex_x
    return _fetch_texel(scene, idx.long()) * 0.0039215


def surface_color(scene, attrs, tex_filter: str = "nearest") -> torch.Tensor:
    """Nearest texture sample where the material is textured, else its
    albedo."""
    if tex_filter != "nearest":
        raise NotImplementedError(
            f"texture filter {tex_filter!r} is not ported yet (ROADMAP item 9)")
    alb = scene.mat_albedo[attrs.material]
    if not scene.has_textures:
        return alb
    start = scene.mat_tex_start[attrs.material]
    w = scene.mat_tex_w[attrs.material]
    h = scene.mat_tex_h[attrs.material]
    tex = _sample_texture_nearest(scene, start, w, h, attrs.uv)
    return torch.where((start >= 0)[..., None], tex, alb)


def sky_radiance(scene, directions: torch.Tensor) -> torch.Tensor:
    """Per-ray sky radiance [..., 3] f32 in [0, 1]: the reference's flat
    constant. Environment-map skies are not ported yet."""
    if scene.has_sky:
        raise NotImplementedError("environment-map skies are not ported yet "
                                  "(ROADMAP item 9)")
    flat = torch.tensor(SKY_COLOR, dtype=torch.float32, device=directions.device) / 255.0
    return flat.expand(directions.shape[:-1] + (3,))


def light_vector(light_direction, device, exact: bool = True) -> torch.Tensor:
    """The unit vector toward the directional light."""
    return normalize(torch.tensor(light_direction, dtype=torch.float32, device=device),
                     exact=exact)


def compute_illumination(scene, attrs, light_direction, mode: str, exact: bool = True,
                         backend: str = "cuda", directions=None, point_lights: tuple = (),
                         cast_fn=None, nearest_cast_fn=None) -> torch.Tensor:
    """Scalar illumination per ray.

    ``flat``: 1 (the reference's active path). ``lambert``: the cosine
    to the light. ``lambert_shadow``: the cosine where a shadow ray
    toward the light escapes, else 0.4 times it. ``blinn_phong``: the
    cosine plus a half-vector specular lobe (needs ``directions``, the
    primary ray directions). Every mode ends clamped to [0.4, 1];
    ``light_direction=None`` drops the light. ``cast_fn`` replaces the
    shadow cast (default: the backend's any-hit cast); ``nearest_cast_fn``
    serves only point lights, which are not ported yet."""
    if point_lights:
        raise NotImplementedError("point lights are not ported yet (ROADMAP item 8)")
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
            from .renderer import occlusion_cast_fn
            from .sorted_cast import park_dead_rays

            cast = cast_fn if cast_fn is not None else occlusion_cast_fn(backend)
            # Shadow rays only where the primary hit and the cosine is
            # above 0.4: below it the final clamp maps lit (cos) and
            # shadowed (0.4 cos) to the same 0.4, so the answer cannot
            # show. Parked rays miss, so they read as lit.
            need = attrs.hit & (cos_illum > 0.4)
            occ = cast(scene, *park_dead_rays(
                attrs.location + light_dir * SHADOW_EPS,
                light_dir.expand(attrs.location.shape), need))
            lit = occ.t >= FLT_MAX
            illum = torch.where(lit, cos_illum, 0.4 * cos_illum)
        elif mode != "lambert":
            raise ValueError(f"unknown lighting mode: {mode}")
    illum = torch.clamp(illum, max=1.0)
    return torch.clamp(illum, min=0.4)


def shade_primary(scene, attrs, light_direction=DEFAULT_LIGHT_DIRECTION, mode: str = "flat",
                  exact: bool = True, backend: str = "cuda", directions=None,
                  point_lights: tuple = (), tex_filter: str = "nearest", cast_fn=None,
                  nearest_cast_fn=None) -> torch.Tensor:
    """Primary-hit shade -> uint8 [..., 3] in the reference's channel
    order; misses take the sky colour."""
    if scene.has_sky:
        raise NotImplementedError("environment-map skies are not ported yet "
                                  "(ROADMAP item 9)")
    color = surface_color(scene, attrs, tex_filter)
    illum = compute_illumination(
        scene, attrs, light_direction, mode, exact=exact, backend=backend,
        directions=directions, point_lights=point_lights, cast_fn=cast_fn,
        nearest_cast_fn=nearest_cast_fn)
    rgb = illum[..., None] * color * 255.0
    shaded = rgb.to(torch.uint8)  # truncates like the C cast
    sky = torch.tensor(SKY_COLOR, dtype=torch.uint8, device=shaded.device)
    return torch.where(attrs.hit[..., None], shaded, sky)
