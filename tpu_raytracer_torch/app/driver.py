"""Application driver: N timed frames, FPS printed per frame, the last
frame written as a PNG (counterpart of ``tpu_raytracer/app/driver.py``).

    python -m tpu_raytracer_torch.app.driver --scene demo --frames 10
    python -m tpu_raytracer_torch.app.driver --scene instances --mode whitted
    python -m tpu_raytracer_torch.app.driver --scene colonnade --mode path --fly
    python -m tpu_raytracer_torch.app.driver --scene cornell --mode ao
    python -m tpu_raytracer_torch.app.driver --scene colonnade --backend paged
    python -m tpu_raytracer_torch.app.driver --sky gradient --texture-filter trilinear
    python -m tpu_raytracer_torch.app.driver --scene instances --mode whitted \
        --point-light 0,2,2,4 --normal-mode inverse_transpose --ssaa 2 --aov depth

Frames render through the compiled entry points (``render/compiled.py``:
on the card each mode's frame is captured once as a CUDA graph and
replayed with the frame's camera, instances and key) on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions) through
``--backend``: ``cuda`` (K1/K3), ``bvh``
(K2), ``paged`` (K4), ``paged_major`` (K6) or ``brute``; the paged
backends attach the scene's page tables once, before the first frame.
``--mode`` is ``primary``, ``whitted`` (config 4), ``path`` (config 5: 3
bounces, 4 samples, a fresh key per frame split from ``PRNGKey(0)`` as
the JAX driver does; ``--path-lights``, ``--denoise``, ``--lens-radius``
and ``--focus-distance`` apply) or ``ao`` (8 samples within
``--ao-radius``). ``--fly`` moves the camera forward and turns it a
little every frame. The default ``demo`` scene is the reference app's: a
textured cube and board under the reference fisheye calibration at
1920x1088, with the cube (instance 0) spinning through
``update_instance`` every frame. ``--lighting``, ``--point-light
X,Y,Z[,I]`` (repeatable), ``--no-sun``, ``--normal-mode``,
``--texture-filter``, ``--sky gradient`` (the demo scene's equirect sky
map), ``--calib`` (the reference fisheye calibration, K rescaled) and
``--ssaa N`` shape the frames as in the JAX driver; each ``--aov NAME``
also writes that buffer of ``render_aovs`` as ``<out>.<NAME>.png``. The
last frame is saved with its FPS burnt in (``utils.image.overlay_fps``,
unlabelled where OpenCV does not import). ``--web PORT`` serves the live
browser viewer (``app/web.py``, in ``--mode``) on ``--web-host``
(default loopback) instead of the timed loop.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from ..render import Camera, RenderConfig, reference_calibration
from ..render.integrators import PointLight
from ..render.pipeline import (
    compiled_render_aovs, compiled_render_image, compiled_render_image_ao,
    compiled_render_image_path_traced, compiled_render_image_whitted,
)
from ..render.renderer import BACKENDS, NORMAL_MODES
from ..render.shade import DEFAULT_LIGHT_DIRECTION, TEXTURE_FILTERS
from ..scene import MeshInstance, procgen
from ..utils import overlay_fps, prng, save_png
from .controls import fly as fly_step
from .scenes import SCENES, build_demo_scene

MODES = ("primary", "whitted", "path", "ao")
AOVS = ("depth", "normal", "uv", "instance", "triangle", "hit")
PATH_BOUNCES, PATH_SAMPLES = 3, 4
AO_SAMPLES = 8


def _aov_to_u8(name: str, a: np.ndarray) -> np.ndarray:
    """An AOV buffer as a u8 image: depth as a normalised inverse ramp
    (near is bright), normals mapped from [-1, 1], uv into two channels,
    ids through a hashed palette, the hit mask white on black."""
    if name == "depth":
        finite = np.isfinite(a)
        if finite.any():
            lo, hi = a[finite].min(), a[finite].max()
            g = np.where(finite, 1.0 - (a - lo) / max(hi - lo, 1e-9), 0.0)
        else:
            g = np.zeros_like(a)
        return np.repeat((g * 255).astype(np.uint8)[..., None], 3, -1)
    if name == "normal":
        return ((a * 0.5 + 0.5) * 255).astype(np.uint8)
    if name == "uv":
        img = np.zeros(a.shape[:-1] + (3,), np.uint8)
        img[..., 0] = (np.clip(a[..., 0], 0, 1) * 255).astype(np.uint8)
        img[..., 1] = (np.clip(a[..., 1], 0, 1) * 255).astype(np.uint8)
        return img
    if name in ("instance", "triangle"):
        h = (a.astype(np.int64) * 2654435761) & 0xFFFFFF
        img = np.stack([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF], -1)
        return np.where((a >= 0)[..., None], img, 0).astype(np.uint8)
    return (a.astype(np.uint8) * 255)[..., None].repeat(3, -1)


def run(scene_name: str = "demo", width: int = 1920, height: int = 1088,
        frames: int = 10, out: str = "out.png", device: str = "cuda",
        mode: str = "primary", lighting: str = "flat", animate: bool = True,
        backend: str = "cuda", fly: bool = False, ao_radius: float = 1.0,
        denoise: int = 0, path_lights: bool = False, lens_radius: float = 0.0,
        focus_distance: float = 4.0, tonemap: str = "none", exposure: float = 1.0,
        point_lights: tuple = (), no_sun: bool = False, texture_filter: str = "nearest",
        ssaa: int = 1, aovs: tuple = (), sky: str = "flat", calib: bool = False,
        normal_mode: str = "reference", web: int | None = None, web_host: str = "127.0.0.1"):
    """Render ``frames`` frames, printing FPS and Mrays/s per frame, and
    save the last with its FPS burnt in; returns that frame, unlabelled,
    as a host uint8 tensor. ``animate`` spins the demo's cube; ``fly``
    flies the camera. ``point_lights`` are (x, y, z) or (x, y, z,
    intensity) tuples; ``aovs`` names the AOV buffers written beside
    ``out`` after the last frame. ``web``: serve the live viewer
    (``app/web.py``, in ``mode``) on this port of ``web_host`` instead of
    the timed loop, and return None when it stops."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the driver has {', '.join(MODES)}")
    if scene_name == "demo":
        demo = build_demo_scene()
        if sky == "gradient":
            demo.set_sky(procgen.sky_gradient_texture())
        scene = demo.compile(device)
        if calib or (width, height) == (1920, 1088):
            K, D = reference_calibration(width, height)
            camera = Camera(width, height, K, D)
        else:
            camera = Camera.looking(width, height, fov_deg=60.0)
        camera.pose = np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32)
    elif scene_name in ("cube", "cornell"):
        scene, camera = SCENES[scene_name](min(width, height), device=device)
    else:
        scene, camera = SCENES[scene_name](width, height, device=device)
    if calib and scene_name != "demo":
        K, D = reference_calibration(camera.width, camera.height)
        camera = Camera(camera.width, camera.height, K, D, pose=camera.pose)
    if backend in ("paged", "paged_major"):
        # force-page a resident scene; one that needs paging has its tables
        # from the compile, and with_paging returns it as it is
        scene = scene.with_paging()
    lights = tuple(PointLight(position=tuple(float(x) for x in p[:3]),
                              intensity=float(p[3]) if len(p) > 3 else 100.0)
                   for p in point_lights)
    config = RenderConfig(camera.width, camera.height, backend=backend, lighting=lighting,
                          light_direction=None if no_sun else DEFAULT_LIGHT_DIRECTION,
                          point_lights=lights, texture_filter=texture_filter, ssaa=ssaa,
                          path_lights=path_lights, tonemap=tonemap, exposure=exposure,
                          denoise=denoise, normal_mode=normal_mode)
    if web is not None:
        from .web import WebViewer

        WebViewer(scene, camera, config, mode=mode, ao_radius=ao_radius).serve(
            host=web_host, port=web)
        return None
    render_fn = {"primary": compiled_render_image,
                 "whitted": compiled_render_image_whitted}.get(mode)
    key = prng.PRNGKey(0)
    cuda = scene.device.type == "cuda"
    angle = 0.0
    img = None
    fps = 0.0
    for _ in range(frames):
        angle += 0.005
        if animate and scene_name == "demo":
            spun = MeshInstance(0, 2)
            spun.pose = np.array([0, 0, 0, angle, 0, 0], np.float32)
            scene = scene.update_instance(0, spun)
        if fly:
            camera.pose = fly_step(camera.pose, forward=0.03)
            camera.pose[3] += 0.004
        if mode == "path":
            key, sub = prng.split(key)
            render_fn = functools.partial(compiled_render_image_path_traced, key=sub,
                                          max_bounces=PATH_BOUNCES, samples=PATH_SAMPLES,
                                          lens_radius=lens_radius,
                                          focus_distance=focus_distance)
        elif mode == "ao":
            key, sub = prng.split(key)
            render_fn = functools.partial(compiled_render_image_ao, key=sub,
                                          samples=AO_SAMPLES, radius=ao_radius)
        start = time.perf_counter()
        p = camera.ray_params(scene.device)
        img = render_fn(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        if cuda:
            torch.cuda.synchronize(scene.device)
        elapsed = time.perf_counter() - start
        fps = 1.0 / elapsed
        mrays = camera.width * camera.height * ssaa * ssaa / elapsed / 1e6
        print(f"FPS: {fps:.2f}  ({mrays:.1f} Mrays/s)")
    img = img.cpu()
    save_png(overlay_fps(img.numpy(), fps), out)
    if aovs:
        p = camera.ray_params(scene.device)
        bufs = compiled_render_aovs(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        stem = out[:-4] if out.endswith(".png") else out
        for name in aovs:
            save_png(_aov_to_u8(name, bufs[name].cpu().numpy()), f"{stem}.{name}.png")
            print(f"AOV {name} -> {stem}.{name}.png")
    return img


def main():
    ap = argparse.ArgumentParser(description="tpu_raytracer_torch demo app")
    ap.add_argument("--scene", default="demo", choices=["demo", *SCENES])
    ap.add_argument("--mode", default="primary", choices=list(MODES))
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--lighting", default="flat",
                    choices=["flat", "lambert", "lambert_shadow", "blinn_phong"])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-animate", action="store_true")
    ap.add_argument("--fly", action="store_true", help="animated camera fly-through")
    ap.add_argument("--ao-radius", type=float, default=1.0,
                    help="--mode ao: world-space occlusion query radius")
    ap.add_argument("--web", type=int, default=None, metavar="PORT",
                    help="serve the live browser viewer on PORT (mouse orbit, WASD fly; "
                         "app/web.py) instead of the timed loop; honours --mode")
    ap.add_argument("--web-host", default="127.0.0.1",
                    help="the viewer's bind address (default loopback; the viewer has no "
                         "auth, and 0.0.0.0 exposes camera control to the network)")
    ap.add_argument("--denoise", type=int, default=0, metavar="N",
                    help="--mode path: N à-trous denoiser iterations (0 = off)")
    ap.add_argument("--path-lights", action="store_true",
                    help="--mode path: next-event estimation toward the sun")
    ap.add_argument("--lens-radius", type=float, default=0.0,
                    help="--mode path: thin-lens aperture radius (0 = pinhole)")
    ap.add_argument("--focus-distance", type=float, default=4.0,
                    help="focal-plane distance for --lens-radius")
    ap.add_argument("--tonemap", default="none", choices=["none", "reinhard", "aces"],
                    help="HDR display mapping of the whitted and path modes")
    ap.add_argument("--exposure", type=float, default=1.0,
                    help="linear exposure multiplier ahead of --tonemap")
    ap.add_argument("--normal-mode", default="reference", choices=list(NORMAL_MODES),
                    help="normal transform under instance scale: reference (right for "
                         "uniform scale only) or inverse_transpose")
    ap.add_argument("--calib", action="store_true",
                    help="the reference's fisheye K/D, K rescaled to the resolution")
    ap.add_argument("--point-light", action="append", default=[], metavar="X,Y,Z[,I]",
                    help="add a point light at X,Y,Z of intensity I (default 100); "
                         "repeatable")
    ap.add_argument("--no-sun", action="store_true",
                    help="drop the directional light (point lights only)")
    ap.add_argument("--sky", default="flat", choices=["flat", "gradient"],
                    help="miss-ray sky: the reference's flat colour, or a procedural "
                         "equirect map (demo scene only)")
    ap.add_argument("--aov", action="append", default=[], choices=list(AOVS),
                    help="also write this AOV buffer as <out>.<aov>.png; repeatable")
    ap.add_argument("--ssaa", type=int, default=1,
                    help="supersampling: N x N rays per pixel, box-averaged")
    ap.add_argument("--texture-filter", default="nearest", choices=list(TEXTURE_FILTERS),
                    help="nearest (the reference's sampling), bilinear or trilinear")
    args = ap.parse_args()
    plights = tuple(tuple(float(v) for v in spec.split(",")) for spec in args.point_light)
    run(scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
        out=args.out, device=args.device, mode=args.mode, lighting=args.lighting,
        animate=not args.no_animate, backend=args.backend, fly=args.fly,
        ao_radius=args.ao_radius, denoise=args.denoise, path_lights=args.path_lights,
        lens_radius=args.lens_radius, focus_distance=args.focus_distance,
        tonemap=args.tonemap, exposure=args.exposure, point_lights=plights,
        no_sun=args.no_sun, texture_filter=args.texture_filter, ssaa=args.ssaa,
        aovs=tuple(args.aov), sky=args.sky, calib=args.calib,
        normal_mode=args.normal_mode, web=args.web, web_host=args.web_host)


if __name__ == "__main__":
    main()
