"""Top-level render pipeline: raygen -> cast -> attributes -> shade.

Counterpart of ``tpu_raytracer/render/pipeline.py``: primary rays (flat
and lit shading, point lights, texture filters, the sky map), the AOV
pass, the Whitted integrator (config 4), path tracing with its optional
denoise (config 5) and ambient occlusion, each supersampled where the
JAX package supersamples (``RenderConfig.ssaa``). Every tensor lives on
the scene's device, and the returned image too. Random entry points take
a ``utils.prng`` key.

The jit boundary is the JAX package's: the six entry points it jits
(``render_image``, ``render_aovs``, ``render_image_whitted``,
``render_image_ao``, ``render_radiance_path_traced`` and
``render_image_path_traced``) each have a ``compiled_`` counterpart
(``render/compiled.py``): the config and the other non-tensor arguments
are static, the camera, the key and the scene's per-instance rows and
TLAS are runtime inputs, and on CUDA each static config is captured once
as a CUDA graph and replayed. The eager functions keep their names.
``render`` and ``render_image_paged`` go through ``compiled_render_image``,
as the JAX package's call its jitted ``render_image``; no compiled body
calls them.

The primary, Whitted, path and AO frames are cut into the stages of
``utils/profiling.py``: ``raygen``, ``cast``, ``attrs``, ``shade`` and
``output`` (the supersampling mean, the tonemap and the u8 cast) here,
the integrators' own in ``render/integrators.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import constant
from ..utils.profiling import stage
from .camera import Camera, generate_rays
from .compiled import CompiledFrame
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
    # point lights (integrators.PointLight), in every lit mode and, with
    # path_lights, in the path tracer's NEE; light_direction=None renders
    # with point lights alone
    point_lights: tuple = ()
    # nearest (the reference's sampling) | bilinear | trilinear (mip-mapped,
    # LOD from screen-space uv derivatives on primary rays, bilinear on
    # secondary ones)
    texture_filter: str = "nearest"
    # supersampling: render at ssaa*width x ssaa*height with the
    # intrinsics scaled to keep the field of view, then average each
    # ssaa x ssaa block (1 = one ray per pixel, the reference's)
    ssaa: int = 1
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
    # normal transform under instance scale: reference (rotate, then
    # multiply by the scale: the reference's rule, right for uniform
    # scale) | inverse_transpose (R diag(1/s), right for any scale)
    normal_mode: str = "reference"


def _with_ssaa(config: RenderConfig, K_inv: torch.Tensor, body):
    """``body(cfg, K_inv) -> u8 [h, w, 3]`` at ``config.ssaa`` times the
    resolution, then each ssaa x ssaa block averaged and rounded. K' =
    diag(s, s, 1) K keeps the field of view, so K'^-1 = K^-1 diag(1/s,
    1/s, 1)."""
    s = config.ssaa
    if s <= 1:
        return body(config, K_inv)
    sub = dataclasses.replace(config, width=config.width * s, height=config.height * s, ssaa=1)
    # tensor factors: 1/s computed in f32 as the JAX package does
    inv_s = constant((1.0 / s, 1.0 / s, 1.0), torch.float32, K_inv.device)
    big = body(sub, torch.as_tensor(K_inv, dtype=torch.float32) * inv_s)
    with stage("output"):
        f = big.to(torch.float32).reshape(config.height, s, config.width, s, 3).mean(dim=(1, 3))
        return torch.round(f).to(torch.uint8)

def _rays(config: RenderConfig, scene, K_inv, D, pose, inv_pose):
    dev = scene.device
    with stage("raygen"):
        return generate_rays(config.width, config.height, K_inv.to(dev), D.to(dev),
                             pose.to(dev), inv_pose.to(dev), exact=config.exact_math)


def shade_rays(config: RenderConfig, scene, origin, directions) -> torch.Tensor:
    """The primary pass on given rays (no supersampling): cast,
    attributes and shade -> uint8 ``[..., 3]``. The cast carries normals
    where the lighting reads them (every mode but ``flat``)."""
    cast = get_cast_fn(config.backend, want_normals=config.lighting != "flat")
    with stage("cast"):
        hit = cast(scene, origin, directions)
    with stage("attrs"):
        attrs = hit_attributes(scene, origin, directions, hit, exact=config.exact_math,
                               normal_mode=config.normal_mode)
    with stage("shade"):
        return shade_primary(scene, attrs, config.light_direction, config.lighting,
                             exact=config.exact_math, backend=config.backend,
                             directions=directions, point_lights=config.point_lights,
                             tex_filter=config.texture_filter)


def render_image(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                 pose: torch.Tensor, inv_pose: torch.Tensor) -> torch.Tensor:
    """Render one frame -> uint8 [H, W, 3] (reference channel order) on
    the scene's device (``shade_rays`` on the camera's rays)."""
    def body(cfg, K_inv_b):
        origin, directions = _rays(cfg, scene, K_inv_b, D, pose, inv_pose)
        return shade_rays(cfg, scene, origin, directions)

    return _with_ssaa(config, K_inv, body)


def render_aovs(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                pose: torch.Tensor, inv_pose: torch.Tensor) -> dict:
    """Arbitrary-output-variable pass: per-pixel ``depth`` [H, W] f32
    (world distance, +inf on a miss), ``normal`` [H, W, 3] (world unit
    normal, 0 on a miss), ``uv`` [H, W, 2], ``instance`` and ``triangle``
    [H, W] i32 (-1 on a miss) and ``hit`` [H, W] bool, from one primary
    cast that carries normals."""
    origin, directions = _rays(config, scene, K_inv, D, pose, inv_pose)
    hit = get_cast_fn(config.backend, want_normals=True)(scene, origin, directions)
    attrs = hit_attributes(scene, origin, directions, hit, exact=config.exact_math,
                           normal_mode=config.normal_mode)
    miss_i = torch.full_like(hit.tri, -1)
    return {
        "depth": torch.where(attrs.hit, attrs.t, torch.full_like(attrs.t, float("inf"))),
        "normal": torch.where(attrs.hit[..., None], attrs.normal, 0.0),
        "uv": torch.where(attrs.hit[..., None], attrs.uv, 0.0),
        "instance": torch.where(attrs.hit, attrs.inst.to(torch.int32), miss_i),
        "triangle": torch.where(attrs.hit, hit.tri.to(torch.int32), miss_i),
        "hit": attrs.hit,
    }


def render_image_paged(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                       pose: torch.Tensor, inv_pose: torch.Tensor) -> torch.Tensor:
    """Primary render through the paged kernel (K4 on 4-wide page
    tables, K5 on binary ones): ``render_image`` with the ``paged``
    backend (through ``compiled_render_image``). The scene carries its page
    tables: attach them once with ``scene.with_paging()``."""
    return compiled_render_image(dataclasses.replace(config, backend="paged"), scene, K_inv, D,
                                 pose, inv_pose)


def render(camera: Camera, scene, config: RenderConfig | None = None, **kw) -> torch.Tensor:
    """Render with a host Camera (inverse pose computed per call) through
    ``compiled_render_image``."""
    if config is None:
        config = RenderConfig(width=camera.width, height=camera.height, **kw)
    p = camera.ray_params(scene.device)
    return compiled_render_image(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])


def render_image_whitted(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                         pose: torch.Tensor, inv_pose: torch.Tensor, max_bounces: int = 2,
                         shadows: bool = True) -> torch.Tensor:
    """Whitted reflective render -> uint8 [H, W, 3] (BASELINE config 4)."""
    def body(cfg, K_inv_b):
        origin, directions = _rays(cfg, scene, K_inv_b, D, pose, inv_pose)
        return whitted_rays(cfg, scene, origin, directions, max_bounces, shadows)

    return _with_ssaa(config, K_inv, body)


def whitted_rays(config: RenderConfig, scene, origin, directions, max_bounces: int = 2,
                 shadows: bool = True, **kw) -> torch.Tensor:
    """The Whitted integrator on given rays, tonemapped -> uint8
    ``[..., 3]``; ``kw`` goes to ``integrators.render_whitted``."""
    from .integrators import render_whitted, to_u8, tonemap

    radiance = render_whitted(scene, origin, directions, max_bounces=max_bounces,
                              backend=config.backend, light_direction=config.light_direction,
                              point_lights=config.point_lights, shadows=shadows,
                              exact=config.exact_math, tex_filter=config.texture_filter,
                              normal_mode=config.normal_mode, **kw)
    with stage("output"):
        return to_u8(tonemap(radiance, config.tonemap, config.exposure))


def render_image_ao(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                    pose: torch.Tensor, inv_pose: torch.Tensor, key: torch.Tensor,
                    samples: int = 8, radius: float = 1.0) -> torch.Tensor:
    """Ambient-occlusion render -> grey uint8 [H, W, 3]."""
    from .integrators import render_ao, to_u8

    def body(cfg, K_inv_b):
        origin, directions = _rays(cfg, scene, K_inv_b, D, pose, inv_pose)
        ao = render_ao(scene, origin, directions, key, samples=samples, radius=radius,
                       backend=cfg.backend, exact=cfg.exact_math, normal_mode=cfg.normal_mode)
        with stage("output"):
            return to_u8(ao[..., None].expand(ao.shape + (3,)))

    return _with_ssaa(config, K_inv, body)


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
        lens_radius=lens_radius, focus_distance=focus_distance, **path_options(config), **kw)


def path_options(config: RenderConfig) -> dict:
    """The ``integrators.render_path_traced`` arguments that ``config``
    sets: backend, maths, texture filter, normal mode and, with
    ``path_lights``, the lights of next-event estimation."""
    return dict(backend=config.backend, exact=config.exact_math,
                tex_filter=config.texture_filter,
                light_direction=config.light_direction if config.path_lights else None,
                point_lights=config.point_lights if config.path_lights else (),
                sun_intensity=config.sun_intensity, normal_mode=config.normal_mode)


def render_image_path_traced(config: RenderConfig, scene, K_inv: torch.Tensor, D: torch.Tensor,
                             pose: torch.Tensor, inv_pose: torch.Tensor, key: torch.Tensor,
                             max_bounces: int = 3, samples: int = 4, lens_radius: float = 0.0,
                             focus_distance: float = 4.0, **kw) -> torch.Tensor:
    """Monte-Carlo path-traced render -> uint8 [H, W, 3] (BASELINE config
    5), denoised with ``config.denoise`` iterations (one more primary
    cast, carrying normals, for the normal and depth guides), then
    tonemapped; supersampled with ``config.ssaa``."""
    from .integrators import to_u8, tonemap

    def body(cfg, K_inv_b):
        radiance = render_radiance_path_traced(cfg, scene, K_inv_b, D, pose, inv_pose, key,
                                               max_bounces, samples, lens_radius,
                                               focus_distance, **kw)
        if cfg.denoise > 0:
            from .denoise import atrous_denoise

            origin, directions = _rays(cfg, scene, K_inv_b, D, pose, inv_pose)
            hit = get_cast_fn(cfg.backend, want_normals=True)(scene, origin, directions)
            attrs = hit_attributes(scene, origin, directions, hit, exact=cfg.exact_math,
                                   normal_mode=cfg.normal_mode)
            radiance = atrous_denoise(
                radiance, torch.where(attrs.hit[..., None], attrs.normal, 0.0),
                torch.where(attrs.hit, attrs.t, torch.full_like(attrs.t, float("inf"))),
                iterations=cfg.denoise)
        with stage("output"):
            return to_u8(tonemap(radiance, cfg.tonemap, cfg.exposure))

    return _with_ssaa(config, K_inv, body)


# the JAX-jitted entry points, compiled per static config (render/compiled.py)
compiled_render_image = CompiledFrame(render_image)
compiled_render_aovs = CompiledFrame(render_aovs)
compiled_render_image_whitted = CompiledFrame(render_image_whitted)
compiled_render_image_ao = CompiledFrame(render_image_ao)
compiled_render_radiance_path_traced = CompiledFrame(render_radiance_path_traced)
compiled_render_image_path_traced = CompiledFrame(render_image_path_traced)
COMPILED = (compiled_render_image, compiled_render_aovs, compiled_render_image_whitted,
            compiled_render_image_ao, compiled_render_radiance_path_traced,
            compiled_render_image_path_traced)


def clear_compiled() -> None:
    """Drop every compiled entry point's entries (``CompiledFrame.clear``),
    the sharded ones' (``parallel.COMPILED_SHARDED``) too."""
    from ..parallel import COMPILED_SHARDED

    for frame in COMPILED + COMPILED_SHARDED:
        frame.clear()
