"""Whitted reflections and the display mapping of float radiance.

Counterpart of ``tpu_raytracer/render/integrators.py`` for the Whitted
integrator (BASELINE config 4): each bounce casts the whole ray batch
through the backend's nearest-hit cast, with terminated rays parked
rather than compacted; the directional light's hard shadows use the
any-hit cast. Colours are float [0, 1] until ``to_u8``. The ray-retiling
and scene-sharded variants of the JAX integrator are not ported; point
lights (ROADMAP item 8) and path tracing, AO and denoising (item 12)
are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.vecmath import FLT_MAX, dot, normalize
from .renderer import get_cast_fn, hit_attributes, occlusion_cast_fn
from .shade import (
    DEFAULT_LIGHT_DIRECTION, SHADOW_EPS, light_vector, sky_radiance, surface_color,
)
from .sorted_cast import park_dead_rays, secondary_cast_fn


def _reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _direct_illumination(scene, cast, attrs, light_direction, point_lights, exact, shadows,
                         occ_cast=None, shadow_floor=0.4, clamp_floor=None):
    """Directional contribution at the hit points, with a hard shadow ray
    toward the light where ``shadows``: the occluded term keeps
    ``shadow_floor`` times the cosine. ``occ_cast`` is the any-hit cast
    for that boolean query (default ``cast``). Rays whose answer cannot
    show park: where the cosine is 0, or, with a caller-side clamp at
    ``clamp_floor``, at or below that floor."""
    if point_lights:
        raise NotImplementedError("point lights are not ported yet (ROADMAP item 8)")
    illum = torch.zeros(attrs.t.shape, dtype=torch.float32, device=attrs.t.device)
    if light_direction is not None:
        ldir = light_vector(light_direction, attrs.t.device, exact)
        cos_i = torch.clamp(dot(attrs.normal, ldir), min=0.0)
        if shadows:
            thresh = clamp_floor if clamp_floor is not None else 0.0
            need = attrs.hit & (cos_i > thresh)
            occ = (occ_cast or cast)(scene, *park_dead_rays(
                attrs.location + ldir * SHADOW_EPS, ldir.expand(attrs.location.shape), need))
            lit = occ.t >= FLT_MAX
            cos_i = torch.where(lit, cos_i, shadow_floor * cos_i)
        illum = illum + cos_i
    return illum


def render_whitted(scene, origin, directions, max_bounces: int = 2, backend: str = "cuda",
                   light_direction=DEFAULT_LIGHT_DIRECTION, point_lights: tuple = (),
                   shadows: bool = True, exact: bool = True, sort_secondary: bool = False,
                   tex_filter: str = "nearest", normal_mode: str = "reference") -> torch.Tensor:
    """Whitted-style mirror reflections, unrolled over bounces -> float
    radiance [..., 3] in [0, 1].

    Local shading is weighted (1 - reflectivity); a mirror bounce
    continues with weight reflectivity. Illumination is clamped to
    [0.4, 1] as in the primary pass, so shadow rays with a cosine at or
    below 0.4 park."""
    cast = get_cast_fn(backend)
    cast2 = secondary_cast_fn(cast, sort_secondary)
    occ_cast = occlusion_cast_fn(backend)
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape).contiguous()
    shape = directions.shape[:-1]
    dev = directions.device

    radiance = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones(shape + (3,), dtype=torch.float32, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    o, d = origin, directions
    for bounce in range(max_bounces + 1):
        hit = (cast if bounce == 0 else cast2)(scene, o, d)
        attrs = hit_attributes(scene, o, d, hit, exact=exact, normal_mode=normal_mode)

        miss = active & ~attrs.hit
        sky = sky_radiance(scene, d)
        radiance = radiance + torch.where(miss[..., None], throughput * sky, 0.0)

        live = active & attrs.hit
        color = surface_color(scene, attrs, tex_filter)
        illum = _direct_illumination(scene, cast2, attrs, light_direction, point_lights, exact,
                                     shadows, occ_cast=occ_cast, clamp_floor=0.4)
        illum = torch.clamp(illum, 0.4, 1.0)
        refl = scene.mat_reflectivity[attrs.material]
        emit = scene.mat_illumination[attrs.material]
        local = color * illum[..., None] * (1.0 - refl[..., None]) + emit[..., None]
        radiance = radiance + torch.where(live[..., None], throughput * local, 0.0)

        if bounce == max_bounces:
            break
        throughput = throughput * torch.where(live[..., None], color * refl[..., None], 0.0)
        active = live & (refl > 0.0)
        d = normalize(_reflect(d, attrs.normal), exact=exact)
        o = attrs.location + d * SHADOW_EPS
        o, d = park_dead_rays(o, d, active)
    return radiance


def to_u8(radiance: torch.Tensor) -> torch.Tensor:
    """Float radiance -> uint8 with the reference's truncating cast,
    clamped to the displayable range."""
    return torch.clamp(radiance * 255.0, 0.0, 255.0).to(torch.uint8)


def tonemap(radiance: torch.Tensor, mode: str = "none", exposure: float = 1.0) -> torch.Tensor:
    """HDR -> display mapping ahead of the uint8 cast: ``none`` (linear
    times exposure), ``reinhard`` (x / (1 + x)) or ``aces`` (Narkowicz's
    fit), the last two followed by a 1/2.2 gamma."""
    x = radiance * exposure
    if mode == "none":
        return x
    if mode == "reinhard":
        y = x / (1.0 + x)
    elif mode == "aces":
        y = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    else:
        raise ValueError(f"unknown tonemap mode {mode!r}")
    return torch.pow(torch.clamp(y, min=0.0), 1.0 / 2.2)
