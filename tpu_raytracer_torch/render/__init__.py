from .camera import Camera, default_intrinsics, generate_rays, reference_calibration
from .compiled import CompiledFrame
from .pipeline import (
    RenderConfig, clear_compiled, compiled_render_aovs, compiled_render_image,
    compiled_render_image_ao, compiled_render_image_path_traced, compiled_render_image_whitted,
    compiled_render_radiance_path_traced, render, render_aovs, render_image, render_image_ao,
    render_image_paged, render_image_path_traced, render_image_whitted,
    render_radiance_path_traced,
)
from .renderer import Hit, HitAttributes, cast_rays_brute, get_cast_fn, hit_attributes
from .shade import shade_primary

__all__ = [
    "Camera",
    "CompiledFrame",
    "Hit",
    "HitAttributes",
    "RenderConfig",
    "cast_rays_brute",
    "clear_compiled",
    "compiled_render_aovs",
    "compiled_render_image",
    "compiled_render_image_ao",
    "compiled_render_image_path_traced",
    "compiled_render_image_whitted",
    "compiled_render_radiance_path_traced",
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
