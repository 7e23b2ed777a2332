"""Top-level render pipeline: raygen -> cast -> attributes -> shade.

Counterpart of ``tpu_raytracer/render/pipeline.py`` for primary rays
(flat and lit shading) and the Whitted integrator. PyTorch runs eagerly,
so the entry points are plain functions; every tensor lives on the
scene's device, and the returned image too. Texture filters,
supersampling and the AOV pass (ROADMAP item 9), point lights (item 8)
and the path and AO integrators (item 12) are not ported yet.
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
    # brute | cuda (K1/K3) | paged (K4 on 4-wide pages, K5 on binary) |
    # paged_major (K6)
    backend: str = "cuda"
    lighting: str = "flat"  # flat | lambert | lambert_shadow | blinn_phong
    light_direction: tuple | None = DEFAULT_LIGHT_DIRECTION
    exact_math: bool = True  # False: the reference's q_rsqrt normalize
    # HDR -> display mapping of the Whitted integrator (the primary pass
    # keeps the reference's raw truncating cast): none | reinhard | aces
    tonemap: str = "none"
    exposure: float = 1.0


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
