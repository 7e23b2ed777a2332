"""Top-level render pipeline: raygen -> cast -> attributes -> shade.

Counterpart of ``tpu_raytracer/render/pipeline.py``: primary rays (flat
and lit shading), the Whitted integrator (config 4), path tracing with
its optional denoise (config 5) and ambient occlusion. PyTorch runs
eagerly, so the entry points are plain functions; every tensor lives on
the scene's device, and the returned image too. Random entry points
take a ``utils.prng`` key. Texture filters, supersampling and the AOV
pass (ROADMAP item 9) and point lights (item 8) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import Camera, generate_rays
from .renderer import get_cast_fn, hit_attributes
from .shade import DEFAULT_LIGHT_DIRECTION, shade_primary


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render options of the ported paths."""

    width: int
    height: int
    # brute | bvh (K2) | cuda (K1/K3) | paged (K4 on 4-wide pages, K5 on
    # binary) | paged_major (K6)
    backend: str = "cuda"
    lighting: str = "flat"  # flat | lambert | lambert_shadow | blinn_phong
    light_direction: tuple | None = DEFAULT_LIGHT_DIRECTION
    exact_math: bool = True  # False: the reference's q_rsqrt normalize
    # path tracing: next-event estimation toward light_direction at every
    # bounce (an any-hit shadow cast each), scaled by sun_intensity
    path_lights: bool = False
    sun_intensity: float = 1.0
    # HDR -> display mapping of the Whitted and path integrators (the
    # primary pass keeps the reference's raw truncating cast): none |
    # reinhard | aces
    tonemap: str = "none"
    exposure: float = 1.0
    # à-trous denoiser iterations of the path image (0 = off), guided by
    # the first hit's normal and depth, applied ahead of the tonemap
    denoise: int = 0


def _rays(config: RenderConfig, scene, K_inv, D, pose, inv_pose):
    dev = scene.device
    return generate_rays(config.width, config.height, K_inv.to(dev), D.to(dev),
                         pose.to(dev), inv_pose.to(dev), exact=config.exact_math)


def render_image(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                 pose: torch.Tensor, inv_pose: torch.Tensor) -> torch.Tensor:
    """Render one frame -> uint8 [H, W, 3] (reference channel order) on
    the scene's device."""
    origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
    hit = get_cast_fn(config.backend)(scene, origin, directions)
    attrs = hit_attributes(scene, origin, directions, hit, exact=config.exact_math)
    return shade_primary(scene, attrs, config.light_direction, config.lighting,
                         exact=config.exact_math, backend=config.backend,
                         directions=directions)


def render_image_paged(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                       pose: torch.Tensor, inv_pose: torch.Tensor) -> torch.Tensor:
    """Primary render through the paged kernel (K4 on 4-wide page
    tables, K5 on binary ones): ``render_image`` with the ``paged``
    backend. The scene carries its page tables: attach them once with
    ``scene.with_paging()``."""
    return render_image(dataclasses.replace(config, backend="paged"), scene, K_inv, D, pose,
                        inv_pose)


def render(camera: Camera, scene, config: RenderConfig | None = None, **kw) -> torch.Tensor:
    """Render with a host Camera (inverse pose computed per call)."""
    if config is None:
        config = RenderConfig(width=camera.width, height=camera.height, **kw)
    p = camera.ray_params(scene.device)
    return render_image(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])


def render_image_whitted(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                         pose: torch.Tensor, inv_pose: torch.Tensor, max_bounces: int = 2,
                         shadows: bool = True) -> torch.Tensor:
    """Whitted reflective render -> uint8 [H, W, 3] (BASELINE config 4)."""
    from .integrators import render_whitted, to_u8, tonemap

    origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
    radiance = render_whitted(scene, origin, directions, max_bounces=max_bounces,
                              backend=config.backend, light_direction=config.light_direction,
                              shadows=shadows, exact=config.exact_math)
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))


def render_image_ao(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                    pose: torch.Tensor, inv_pose: torch.Tensor, key: torch.Tensor,
                    samples: int = 8, radius: float = 1.0) -> torch.Tensor:
    """Ambient-occlusion render -> grey uint8 [H, W, 3]."""
    from .integrators import render_ao, to_u8

    origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
    ao = render_ao(scene, origin, directions, key, samples=samples, radius=radius,
                   backend=config.backend, exact=config.exact_math)
    return to_u8(ao[..., None].expand(ao.shape + (3,)))


def render_radiance_path_traced(config: RenderConfig, scene, K_inv: torch.Tensor,
                                D: torch.Tensor, pose: torch.Tensor, inv_pose: torch.Tensor,
                                key: torch.Tensor, max_bounces: int = 3, samples: int = 4,
                                lens_radius: float = 0.0, focus_distance: float = 4.0,
                                **kw) -> torch.Tensor:
    """Path-traced HDR radiance -> f32 [H, W, 3] (no denoise, tonemap or
    u8): the entry point of renderers that average frames in linear
    space. ``kw`` goes to ``integrators.render_path_traced``
    (``sort_secondary``, ``sample_batch``, ``fast_tail``)."""
    from .integrators import render_path_traced

    origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
    return render_path_traced(
        scene, origin, directions, key, max_bounces=max_bounces, samples=samples,
        backend=config.backend, exact=config.exact_math, lens_radius=lens_radius,
        focus_distance=focus_distance,
        light_direction=config.light_direction if config.path_lights else None,
        sun_intensity=config.sun_intensity, **kw)


def render_image_path_traced(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                             pose: torch.Tensor, inv_pose: torch.Tensor, key: torch.Tensor,
                             max_bounces: int = 3, samples: int = 4, lens_radius: float = 0.0,
                             focus_distance: float = 4.0, **kw) -> torch.Tensor:
    """Monte-Carlo path-traced render -> uint8 [H, W, 3] (BASELINE config
    5), denoised with ``config.denoise`` iterations (one more primary
    cast for the normal and depth guides), then tonemapped."""
    from .integrators import to_u8, tonemap

    radiance = render_radiance_path_traced(config, scene, K_inv, D, pose, inv_pose, key,
                                           max_bounces, samples, lens_radius, focus_distance,
                                           **kw)
    if config.denoise > 0:
        from .denoise import atrous_denoise

        origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
        attrs = hit_attributes(scene, origin, directions,
                               get_cast_fn(config.backend)(scene, origin, directions),
                               exact=config.exact_math)
        radiance = atrous_denoise(
            radiance, torch.where(attrs.hit[..., None], attrs.normal, 0.0),
            torch.where(attrs.hit, attrs.t, torch.full_like(attrs.t, float("inf"))),
            iterations=config.denoise)
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))
