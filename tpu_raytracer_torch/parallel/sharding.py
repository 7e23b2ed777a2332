"""Multi-device rendering in row bands: the image split over the ranks,
the scene replicated.

Counterpart of ``tpu_raytracer/parallel/sharding.py``. Rank i of n
renders rows ``[i * H/n, (i + 1) * H/n)``: raygen, cast and shade (or the
Whitted or path integrator) on its band alone, then ``gather_rows``
assembles the bands into the full ``uint8 [H, W, 3]`` image on every
rank. Each rank holds the whole scene on its own device, and the bounce
loops stay in the band, so the gather is the only collective.

A band's pixels are the single-device render's bit for bit: every stage
is per pixel. The exceptions are those of the JAX package: the path
tracer draws rank i's samples from ``fold_in(key, i)`` on the band's own
shape, and the trilinear filter's screen derivatives stop at a band's
edge. A band whose height is not a multiple of 16 casts the
``paged_major`` backend (K6) in flat ray order instead of 16x16 tiles.

Each entry has a ``compiled_`` counterpart with its signature, as the
JAX package jits its band bodies: the band's frame is one CUDA graph per
rank, static config and group (``render/compiled.py``), replayed with the
camera, the key and the scene's per-instance rows and TLAS bound, and
``gather_rows`` runs after the replay on either backend (the JAX package
too assembles the bands when the image is fetched, not inside its jit).
So the graph holds no collective, and the bands of ranks that share a
card under gloo are captured too. ``check_sharded_config`` refuses a
config at the call, before any key is made.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..render.camera import generate_rays
from ..render.compiled import CompiledFrame
from ..render.integrators import render_path_traced, to_u8, tonemap
from ..render.pipeline import RenderConfig, path_options, shade_rays, whitted_rays
from ..utils import prng
from .group import Group


def check_sharded_config(config: RenderConfig, path: bool = False) -> None:
    """Refuse what the sharded renders would silently drop: supersampling,
    and the denoiser of the path render."""
    if config.ssaa != 1:
        raise ValueError("sharded rendering does not apply ssaa supersampling; "
                         "render at a higher resolution or supersample per shard")
    if path and config.denoise:
        raise ValueError("sharded path rendering does not run the denoiser; "
                         "denoise the gathered image on one device")


def band_rays(config: RenderConfig, group: Group, scene, K_inv, D, pose, inv_pose):
    """(origin [3], directions [H/n, W, 3]) of this rank's band of rows,
    on the scene's device."""
    n = group.world_size
    if config.height % n:
        raise ValueError(f"height {config.height} not divisible by {n} ranks")
    dev = scene.device
    origin, directions = generate_rays(config.width, config.height, K_inv.to(dev), D.to(dev),
                                       pose.to(dev), inv_pose.to(dev), exact=config.exact_math)
    h = config.height // n
    return origin, directions[group.rank * h:(group.rank + 1) * h].contiguous()


def gather_route(backend: str, device: torch.device) -> str:
    """How ``gather_rows`` moves a band on ``device`` under ``backend``:
    gloo gathers no CUDA tensors, so such bands go through host memory."""
    if device.type == "cuda" and backend == "gloo":
        return "gloo all_gather through host memory"
    return f"{backend} all_gather"


def gather_rows(group: Group, band: torch.Tensor) -> torch.Tensor:
    """Every rank's band, concatenated in rank order along the first axis,
    on every rank (on ``band``'s device)."""
    via_host = band.device.type == "cuda" and group.backend == "gloo"
    src = band.cpu() if via_host else band.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world_size)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts)
    return out.to(band.device) if via_host else out


def _band_image(config: RenderConfig, group: Group, scene, K_inv, D, pose,
                inv_pose) -> torch.Tensor:
    """This rank's band of the primary frame: uint8 [H/n, W, 3]."""
    origin, d = band_rays(config, group, scene, K_inv, D, pose, inv_pose)
    return shade_rays(config, scene, origin, d)


def _band_whitted(config: RenderConfig, group: Group, scene, K_inv, D, pose, inv_pose,
                  bounces: int = 2) -> torch.Tensor:
    """This rank's band of the Whitted frame."""
    origin, d = band_rays(config, group, scene, K_inv, D, pose, inv_pose)
    return whitted_rays(config, scene, origin, d, bounces)


def _band_path(config: RenderConfig, group: Group, scene, K_inv, D, pose, inv_pose,
               key: torch.Tensor, bounces: int = 2, samples: int = 2) -> torch.Tensor:
    """This rank's band of the path frame, sampled with ``fold_in(key,
    rank)``."""
    origin, d = band_rays(config, group, scene, K_inv, D, pose, inv_pose)
    key = prng.fold_in(key.to(scene.device), group.rank)
    radiance = render_path_traced(scene, origin, d, key, max_bounces=bounces, samples=samples,
                                  **path_options(config))
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))


def render_image_sharded(config: RenderConfig, group: Group, scene, K_inv, D, pose,
                         inv_pose) -> torch.Tensor:
    """One primary frame with the rows split over ``group``: uint8 [H, W,
    3] on every rank. ``scene`` is the whole scene on this rank's device."""
    check_sharded_config(config)
    return gather_rows(group, _band_image(config, group, scene, K_inv, D, pose, inv_pose))


def render_image_whitted_sharded(config: RenderConfig, group: Group, scene, K_inv, D, pose,
                                 inv_pose, bounces: int = 2) -> torch.Tensor:
    """Whitted reflections with the rows split over ``group``: reflection
    and shadow rays start from the band's own pixels, so the bounce loop
    needs no collective."""
    check_sharded_config(config)
    return gather_rows(group, _band_whitted(config, group, scene, K_inv, D, pose, inv_pose,
                                            bounces))


def render_image_path_traced_sharded(config: RenderConfig, group: Group, scene, K_inv, D,
                                     pose, inv_pose, key: torch.Tensor, bounces: int = 2,
                                     samples: int = 2) -> torch.Tensor:
    """Path tracing with the rows split over ``group``: rank i samples its
    band with ``prng.fold_in(key, i)``, so the bands draw different
    streams, and casts its bounce rays unsorted."""
    check_sharded_config(config, path=True)
    return gather_rows(group, _band_path(config, group, scene, K_inv, D, pose, inv_pose, key,
                                         bounces, samples))


class CompiledSharded(CompiledFrame):
    """A sharded entry point compiled per rank (``render/compiled.py``),
    called as ``(config, group, scene, ...)``: ``check(config, group,
    scene)`` refuses the call before any key is made, ``fn`` is what the
    rank's graph holds, and with ``gather`` its output is this rank's band,
    which ``gather_rows`` assembles after the replay."""

    def __init__(self, fn, check, gather: bool = False, collectives: bool = False,
                 name: str | None = None):
        super().__init__(fn, collectives=collectives, name=name)
        self.check, self.gather = check, gather

    def __call__(self, config, group, scene, *args, **kwargs):
        self.check(config, group, scene)
        out = super().__call__(config, group, scene, *args, **kwargs)
        return gather_rows(group, out) if self.gather else out


compiled_render_image_sharded = CompiledSharded(
    _band_image, lambda c, g, s: check_sharded_config(c), gather=True,
    name="compiled_render_image_sharded")
compiled_render_image_whitted_sharded = CompiledSharded(
    _band_whitted, lambda c, g, s: check_sharded_config(c), gather=True,
    name="compiled_render_image_whitted_sharded")
compiled_render_image_path_traced_sharded = CompiledSharded(
    _band_path, lambda c, g, s: check_sharded_config(c, path=True), gather=True,
    name="compiled_render_image_path_traced_sharded")
