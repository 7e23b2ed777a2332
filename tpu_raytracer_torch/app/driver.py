"""Application driver: N timed frames, FPS printed per frame, the last
frame written as a PNG (counterpart of ``tpu_raytracer/app/driver.py``).

    python -m tpu_raytracer_torch.app.driver --scene demo --frames 10
    python -m tpu_raytracer_torch.app.driver --scene instances --mode whitted
    python -m tpu_raytracer_torch.app.driver --scene colonnade --mode path --fly
    python -m tpu_raytracer_torch.app.driver --scene cornell --mode ao
    python -m tpu_raytracer_torch.app.driver --scene colonnade --backend paged

Frames render on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions) through ``--backend``: ``cuda`` (K1/K3), ``bvh``
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
``update_instance`` every frame. The FPS text overlay of the JAX driver
is not ported.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from ..render import Camera, RenderConfig, reference_calibration, render_image
from ..render.pipeline import render_image_ao, render_image_path_traced, render_image_whitted
from ..render.renderer import BACKENDS
from ..scene import MeshInstance
from ..utils import prng, save_png
from .controls import fly as fly_step
from .scenes import SCENES, build_demo_scene

MODES = ("primary", "whitted", "path", "ao")
PATH_BOUNCES, PATH_SAMPLES = 3, 4
AO_SAMPLES = 8


def run(scene_name: str = "demo", width: int = 1920, height: int = 1088,
        frames: int = 10, out: str = "out.png", device: str = "cuda",
        mode: str = "primary", lighting: str = "flat", animate: bool = True,
        backend: str = "cuda", fly: bool = False, ao_radius: float = 1.0,
        denoise: int = 0, path_lights: bool = False, lens_radius: float = 0.0,
        focus_distance: float = 4.0, tonemap: str = "none", exposure: float = 1.0):
    """Render ``frames`` frames, printing FPS and Mrays/s per frame;
    returns the last frame as a host uint8 tensor. ``animate`` spins the
    demo's cube; ``fly`` flies the camera."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the driver has {', '.join(MODES)}")
    if scene_name == "demo":
        scene = build_demo_scene().compile(device)
        if (width, height) == (1920, 1088):
            K, D = reference_calibration(width, height)
            camera = Camera(width, height, K, D)
        else:
            camera = Camera.looking(width, height, fov_deg=60.0)
        camera.pose = np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32)
    elif scene_name in ("cube", "cornell"):
        scene, camera = SCENES[scene_name](min(width, height), device=device)
    else:
        scene, camera = SCENES[scene_name](width, height, device=device)
    if backend in ("paged", "paged_major"):
        scene = scene.with_paging()
    config = RenderConfig(camera.width, camera.height, backend=backend, lighting=lighting,
                          path_lights=path_lights, tonemap=tonemap, exposure=exposure,
                          denoise=denoise)
    render_fn = {"primary": render_image, "whitted": render_image_whitted}.get(mode)
    key = prng.PRNGKey(0)
    cuda = scene.device.type == "cuda"
    angle = 0.0
    img = None
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
            render_fn = functools.partial(render_image_path_traced, key=sub,
                                          max_bounces=PATH_BOUNCES, samples=PATH_SAMPLES,
                                          lens_radius=lens_radius,
                                          focus_distance=focus_distance)
        elif mode == "ao":
            key, sub = prng.split(key)
            render_fn = functools.partial(render_image_ao, key=sub, samples=AO_SAMPLES,
                                          radius=ao_radius)
        start = time.perf_counter()
        p = camera.ray_params(scene.device)
        img = render_fn(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        if cuda:
            torch.cuda.synchronize(scene.device)
        elapsed = time.perf_counter() - start
        mrays = camera.width * camera.height / elapsed / 1e6
        print(f"FPS: {1.0 / elapsed:.2f}  ({mrays:.1f} Mrays/s)")
    img = img.cpu()
    save_png(img.numpy(), out)
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
    args = ap.parse_args()
    run(scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
        out=args.out, device=args.device, mode=args.mode, lighting=args.lighting,
        animate=not args.no_animate, backend=args.backend, fly=args.fly,
        ao_radius=args.ao_radius, denoise=args.denoise, path_lights=args.path_lights,
        lens_radius=args.lens_radius, focus_distance=args.focus_distance,
        tonemap=args.tonemap, exposure=args.exposure)


if __name__ == "__main__":
    main()
