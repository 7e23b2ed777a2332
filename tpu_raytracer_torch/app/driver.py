"""Application driver: N timed primary-ray frames, FPS printed per frame,
the last frame written as a PNG (counterpart of
``tpu_raytracer/app/driver.py`` in primary, flat mode).

    python -m tpu_raytracer_torch.app.driver --scene bunny --frames 10

Frames render on ``--device`` (default ``cuda``; ``cpu`` runs K1's plain
version). The JAX driver's default two-instance ``demo`` scene needs the
TLAS kernel K3 and is not ported yet (ROADMAP item 10).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..render import RenderConfig, render_image
from ..utils import save_png
from .scenes import SCENES


def run(scene_name: str = "bunny", width: int = 1920, height: int = 1088,
        frames: int = 10, out: str = "out.png", device: str = "cuda"):
    """Render ``frames`` frames, printing FPS and Mrays/s per frame;
    returns the last frame as a host uint8 tensor."""
    if scene_name == "demo":
        raise NotImplementedError(
            "the demo scene has 2 instances and needs the TLAS kernel K3, "
            "which is not ported yet (ROADMAP item 10)")
    if scene_name == "cube":
        scene, camera = SCENES["cube"](min(width, height), device=device)
    else:
        scene, camera = SCENES[scene_name](width, height, device=device)
    config = RenderConfig(camera.width, camera.height, backend="cuda")
    p = camera.ray_params(scene.device)
    cuda = scene.device.type == "cuda"
    img = None
    for _ in range(frames):
        start = time.perf_counter()
        img = render_image(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        if cuda:
            torch.cuda.synchronize(scene.device)
        elapsed = time.perf_counter() - start
        mrays = camera.width * camera.height / elapsed / 1e6
        print(f"FPS: {1.0 / elapsed:.2f}  ({mrays:.1f} Mrays/s)")
    img = img.cpu()
    save_png(img.numpy(), out)
    return img


def main():
    ap = argparse.ArgumentParser(description="tpu_raytracer_torch primary-ray app")
    ap.add_argument("--scene", default="bunny", choices=["demo", *SCENES])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    run(scene_name=args.scene, width=args.width, height=args.height,
        frames=args.frames, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
