"""Application driver: N timed frames, FPS printed per frame, the last
frame written as a PNG (counterpart of ``tpu_raytracer/app/driver.py``
in its primary and Whitted modes).

    python -m tpu_raytracer_torch.app.driver --scene demo --frames 10
    python -m tpu_raytracer_torch.app.driver --scene instances --mode whitted
    python -m tpu_raytracer_torch.app.driver --scene colonnade --backend paged

Frames render on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions) through ``--backend``: ``cuda`` (K1/K3),
``paged`` (K4), ``paged_major`` (K6) or ``brute``; the paged backends
attach the scene's page tables once, before the first frame. The
default ``demo`` scene is the reference app's: a textured cube and
board under the reference fisheye calibration at 1920x1088, with the
cube (instance 0) spinning through ``update_instance`` every frame. The
FPS text overlay of the JAX driver is not ported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..render import Camera, RenderConfig, reference_calibration, render_image
from ..render.pipeline import render_image_whitted
from ..render.renderer import BACKENDS
from ..scene import MeshInstance
from ..utils import save_png
from .scenes import SCENES, build_demo_scene

MODES = {"primary": render_image, "whitted": render_image_whitted}


def run(scene_name: str = "demo", width: int = 1920, height: int = 1088,
        frames: int = 10, out: str = "out.png", device: str = "cuda",
        mode: str = "primary", lighting: str = "flat", animate: bool = True,
        backend: str = "cuda"):
    """Render ``frames`` frames, printing FPS and Mrays/s per frame;
    returns the last frame as a host uint8 tensor. ``animate`` spins the
    demo's cube."""
    if mode in ("path", "ao"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP item 12)")
    render_fn = MODES[mode]
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
    config = RenderConfig(camera.width, camera.height, backend=backend, lighting=lighting)
    p = camera.ray_params(scene.device)
    cuda = scene.device.type == "cuda"
    angle = 0.0
    img = None
    for _ in range(frames):
        angle += 0.005
        if animate and scene_name == "demo":
            spun = MeshInstance(0, 2)
            spun.pose = np.array([0, 0, 0, angle, 0, 0], np.float32)
            scene = scene.update_instance(0, spun)
        start = time.perf_counter()
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
    args = ap.parse_args()
    run(scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
        out=args.out, device=args.device, mode=args.mode, lighting=args.lighting,
        animate=not args.no_animate, backend=args.backend)


if __name__ == "__main__":
    main()
