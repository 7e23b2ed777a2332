"""Primary-ray throughput of the port on the flagship (BASELINE config 3).

    python -m tpu_raytracer_torch.bench

Builds the scene of the root ``bench.py`` (``build_bench_scene``: the
81,920-triangle ``procgen.blob(subdivisions=6)``, one instance,
1920x1088 camera, flat shading) on the first CUDA card, renders it
through ``compiled_render_image`` (one CUDA graph, replayed) with the
``cuda`` backend (kernel K1) and
prints one JSON line with the root bench's keys: ``metric`` (naming the
backend and the card), ``value`` (best-of Mrays/s), ``unit``, ``fps``,
``hit_fraction``. Frames are timed with CUDA events around loops of 10,
repeated until the best stops improving. Fails without a CUDA card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .app.scenes import scene_bunny
from .render import RenderConfig, compiled_render_image
from .render.shade import SKY_COLOR
from .utils.device import card_line


def time_frames(frame, n_iters: int = 10, max_reps: int = 20) -> list[float]:
    """Seconds per loop of ``n_iters`` frames, CUDA-event timed; reps
    stop once the best has not improved by 2% for 3 reps (at least 4)."""
    times: list[float] = []
    since = 0
    for rep in range(max_reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iters):
            frame()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        since = 0 if not times or dt < min(times) * 0.98 else since + 1
        times.append(dt)
        if rep >= 3 and since >= 3:
            break
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tpu_raytracer_torch.bench needs a CUDA card")
    scene, cam = scene_bunny(1920, 1088, device="cuda")
    p = cam.ray_params(scene.device)
    config = RenderConfig(cam.width, cam.height, backend="cuda")

    def frame():
        return compiled_render_image(config, scene, p["K_inv"], p["D"], p["pose"],
                                     p["inv_pose"])

    img = frame().cpu().numpy()  # builds the kernel, captures the graph
    n_iters = 10
    elapsed = min(time_frames(frame, n_iters))
    rays = cam.width * cam.height
    hit_frac = float((img != np.array(SKY_COLOR, np.uint8)).any(-1).mean())
    print(json.dumps({
        "metric": ("primary-ray throughput, 82k-tri BVH scene @1920x1088 "
                   f"(cuda K1, {card_line()})"),
        "value": round(rays * n_iters / elapsed / 1e6, 2),
        "unit": "Mrays/s",
        "fps": round(n_iters / elapsed, 2),
        "hit_fraction": round(hit_frac, 4),
    }))


if __name__ == "__main__":
    main()
