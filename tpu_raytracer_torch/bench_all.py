"""Frame times of the port across the BASELINE configs (counterpart of
the root ``bench_all.py``), one JSON line per config.

    python -m tpu_raytracer_torch.bench_all                  # every config
    python -m tpu_raytracer_torch.bench_all bunny instances  # some
    python -m tpu_raytracer_torch.bench_all cube --device cpu --frames 1

``CONFIGS`` has the root script's keys, scenes and sizes. With no config
or several, each config runs in its own process, so that no config's
allocations or caches shift another's reading; with one, it runs in this
process. Frames render through the compiled entry points
(``render/compiled.py``: on the card one CUDA graph per config, captured
in the warm frame and replayed). A frame is ``timed`` as the root script
times it: one warm frame, then the mean of ``--frames`` frames (8), the card synchronized at
both ends. Each line has the root script's keys (``config``,
``resolution``, ``frame_ms``, ``fps``, ``mrays_per_s``: rays are pixels
times the casts a pixel's frame makes) and ``card``, the card's name and
power limit (``cpu`` on the CPU, whose times are no device measurement).
Frames render on ``--device`` (default ``cuda``) through ``--backend``
(default ``cuda``: K1 on one instance, K3 on more). A config that fails
prints ``{"config": name, "error": ...}`` and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from .app import scenes
from .render import Camera, RenderConfig, reference_calibration
from .render.pipeline import (
    compiled_render_image, compiled_render_image_path_traced, compiled_render_image_whitted,
)
from .render.renderer import BACKENDS

# the casts of config 5b: SAMPLES x (BOUNCES + 1) of the pixel grid per frame
PATH_SAMPLES, PATH_BOUNCES, FLY_FRAMES = 2, 2, 5


class Bench:
    """One config's run: its device, backend and frame count."""

    def __init__(self, device: str, backend: str, frames: int):
        self.device = torch.device(device)
        self.backend = backend
        self.frames = frames
        self.card = "cpu"
        if self.device.type == "cuda":
            from .utils.device import card_line

            self.card = card_line()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, fn) -> float:
        """Seconds per frame: one warm frame, then the mean of
        ``self.frames`` frames, synchronized at both ends."""
        fn()
        self.sync()
        start = time.perf_counter()
        for _ in range(self.frames):
            fn()
        self.sync()
        return (time.perf_counter() - start) / self.frames

    def report(self, name: str, cam, dt: float, casts: float = 1.0) -> None:
        rays = cam.width * cam.height
        print(json.dumps({
            "config": name,
            "resolution": f"{cam.width}x{cam.height}",
            "frame_ms": dt * 1000,
            "fps": 1 / dt,
            "mrays_per_s": rays * casts / dt / 1e6,
            "card": self.card,
        }), flush=True)

    def config(self, cam, **kw) -> RenderConfig:
        return RenderConfig(cam.width, cam.height, backend=self.backend, **kw)

    def args(self, scene, cam) -> tuple:
        if self.backend in ("paged", "paged_major"):
            scene = scene.with_paging()  # the scene itself where its tables are attached
        p = cam.ray_params(scene.device)
        return (scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])


def config_cube(b: Bench):
    scene, cam = scenes.scene_cube(256, device=b.device)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("1 cube 256^2 flat", cam, b.timed(lambda: compiled_render_image(*args)))


def config_cornell(b: Bench):
    scene, cam = scenes.scene_cornell(512, device=b.device)
    args = (b.config(cam, lighting="lambert_shadow"), *b.args(scene, cam))
    b.report("2 cornell 512^2 shadows", cam, b.timed(lambda: compiled_render_image(*args)),
             casts=2.0)


def config_bunny(b: Bench):
    scene, cam = scenes.scene_bunny(device=b.device)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("3 bunny 82k-tri 1080p", cam, b.timed(lambda: compiled_render_image(*args)))


def config_bunny_fisheye(b: Bench):
    # config 3 through the reference's fisheye calibration (kernel.cu:158-164):
    # D != 0 runs the Kannala-Brandt polynomial (raycast.cu:165-177)
    scene, cam = scenes.scene_bunny(device=b.device)
    K, D = reference_calibration(cam.width, cam.height)
    cam = Camera(cam.width, cam.height, K, D, pose=cam.pose)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("3f bunny 1080p real-fisheye K/D", cam, b.timed(lambda: compiled_render_image(*args)))


def config_instances(b: Bench):
    scene, cam = scenes.scene_instances(512, 512, device=b.device)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("4 instances whitted x2", cam, b.timed(lambda: compiled_render_image_whitted(*args)),
             casts=5.0)


def config_instances_flat(b: Bench):
    # the static instances baked into one world-space mesh (Scene.flattened)
    scene, cam = scenes.scene_instances(512, 512, device=b.device, flatten=True)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("4b instances whitted x2 (flattened)", cam,
             b.timed(lambda: compiled_render_image_whitted(*args)), casts=5.0)


def config_instances16(b: Bench):
    # 16 dynamic instances through the TLAS, then their flattened bake
    scene, cam = scenes.scene_instances16(512, 512, device=b.device)
    cfg = b.config(cam)
    args = (cfg, *b.args(scene, cam))
    b.report("6 instances16 dynamic (TLAS)", cam, b.timed(lambda: compiled_render_image(*args)))
    flat, cam = scenes.scene_instances16(512, 512, device=b.device, flatten=True)
    args_f = (cfg, *b.args(flat, cam))
    b.report("6b instances16 flattened-static", cam,
             b.timed(lambda: compiled_render_image(*args_f)))


def config_colonnade(b: Bench):
    scene, cam = scenes.scene_colonnade(512, 512, device=b.device)
    args = (b.config(cam), *b.args(scene, cam))
    b.report("5a colonnade 256k-tri primary", cam, b.timed(lambda: compiled_render_image(*args)))


def config_colonnade_path(b: Bench):
    """BASELINE config 5: path tracing over a 5-pose fly-through, key k
    for frame k, on the colonnade's tree after 2 reinsertion rounds."""
    from .app.controls import fly_through
    from .utils import prng

    scene, cam = scenes.scene_colonnade(512, 512, device=b.device, opt_rounds=2)
    cfg = b.config(cam)
    poses = list(fly_through(cam.pose, frames=FLY_FRAMES, forward_per_frame=0.15))
    params = []
    for q in poses:
        cam.pose = q
        params.append(cam.ray_params(scene.device))

    def frame(k: int):
        p = params[k]
        return compiled_render_image_path_traced(
            cfg, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
            prng.PRNGKey(k, device=scene.device), PATH_BOUNCES, PATH_SAMPLES)

    frame(0)  # warm
    b.sync()
    start = time.perf_counter()
    for k in range(len(poses)):
        frame(k)
    b.sync()
    dt = (time.perf_counter() - start) / len(poses)
    b.report(f"5b colonnade path-traced fly-through ({PATH_SAMPLES}spp x {PATH_BOUNCES + 1} "
             "casts)", cam, dt, casts=PATH_SAMPLES * (PATH_BOUNCES + 1))


CONFIGS = {
    "cube": config_cube,
    "cornell": config_cornell,
    "bunny": config_bunny,
    "bunny_fisheye": config_bunny_fisheye,
    "instances": config_instances,
    "instances_flat": config_instances_flat,
    "instances16": config_instances16,
    "colonnade": config_colonnade,
    "colonnade_path": config_colonnade_path,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's frame times per BASELINE config")
    ap.add_argument("configs", nargs="*", metavar="config",
                    help=f"any of {', '.join(CONFIGS)} (default: all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--frames", type=int, default=8, help="timed frames after the warm one")
    a = ap.parse_args(argv)
    unknown = [c for c in a.configs if c not in CONFIGS]
    if unknown:
        ap.error(f"unknown config {', '.join(unknown)}; the configs are {', '.join(CONFIGS)}")
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_all --device cuda needs a CUDA card")
    if len(a.configs) == 1:
        CONFIGS[a.configs[0]](Bench(a.device, a.backend, a.frames))
        return 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    failed = 0
    for name in a.configs or CONFIGS:
        r = subprocess.run([sys.executable, "-m", "tpu_raytracer_torch.bench_all", name,
                            "--device", a.device, "--backend", a.backend,
                            "--frames", str(a.frames)],
                           capture_output=True, text=True, timeout=1800, cwd=root)
        emitted = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        for ln in emitted:
            print(ln, flush=True)
        if r.returncode != 0 or not emitted:
            failed += 1
            err = r.stderr.strip().splitlines()
            print(json.dumps({"config": name,
                              "error": err[-1][:160] if err else f"exit {r.returncode}"}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
