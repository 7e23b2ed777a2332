from .camera import Camera, default_intrinsics, generate_rays, reference_calibration
from .pipeline import (
    RenderConfig, render, render_aovs, render_image, render_image_ao, render_image_paged,
    render_image_path_traced, render_image_whitted, render_radiance_path_traced,
)
from .renderer import Hit, HitAttributes, cast_rays_brute, get_cast_fn, hit_attributes
from .shade import shade_primary

__all__ = [
    "Camera",
    "Hit",
    "HitAttributes",
    "RenderConfig",
    "cast_rays_brute",
    "default_intrinsics",
    "generate_rays",
    "get_cast_fn",
    "hit_attributes",
    "reference_calibration",
    "render",
    "render_aovs",
    "render_image",
    "render_image_ao",
    "render_image_paged",
    "render_image_path_traced",
    "render_image_whitted",
    "render_radiance_path_traced",
    "shade_primary",
]
