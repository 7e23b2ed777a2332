"""Top-level render pipeline: raygen -> cast -> attributes -> shade.

Counterpart of ``tpu_raytracer/render/pipeline.py`` for primary rays
with flat shading. PyTorch runs eagerly, so ``render_image`` is a plain
function; every tensor lives on the scene's device, and the returned
image too. Lighting modes, texture filters, supersampling, the Whitted,
path and AO integrators and the AOV pass are not ported yet (ROADMAP
items 8, 9, 11 and 12).
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import Camera, generate_rays
from .renderer import get_cast_fn, hit_attributes
from .shade import shade_primary


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render options of the ported primary path."""

    width: int
    height: int
    backend: str = "cuda"  # brute | cuda


def render_image(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                 pose: torch.Tensor, inv_pose: torch.Tensor) -> torch.Tensor:
    """Render one frame -> uint8 [H, W, 3] (reference channel order) on
    the scene's device."""
    dev = scene.device
    origin, directions = generate_rays(
        config.width, config.height, K_inv.to(dev), D.to(dev), pose.to(dev),
        inv_pose.to(dev),
    )
    hit = get_cast_fn(config.backend)(scene, origin, directions)
    attrs = hit_attributes(scene, origin, directions, hit)
    return shade_primary(scene, attrs)


def render(camera: Camera, scene, config: RenderConfig | None = None, **kw) -> torch.Tensor:
    """Render with a host Camera (inverse pose computed per call)."""
    if config is None:
        config = RenderConfig(width=camera.width, height=camera.height, **kw)
    p = camera.ray_params(scene.device)
    return render_image(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
