"""Rendering on several ranks: the image rows split over a process
group, the scene replicated on every rank (``tpu_raytracer_torch.parallel``;
the JAX package's ``examples/05_multichip.py`` shards them over a device
mesh). Each rank is a process started by ``parallel.spawn``, and renders
its band through ``compiled_render_image_sharded``: one CUDA graph per
rank, the bands gathered after the replay.

Run: python examples/torch/05_multichip.py [--device cpu] [--size 128] [--world-size 2]

On the CPU the ranks talk over gloo. On CUDA each rank takes a card of
its own under NCCL where there are enough; otherwise every rank shares
``cuda:0``, under NCCL for one rank and gloo for more (NCCL refuses two
ranks on one card).
"""

import argparse
import functools
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import torch

from tpu_raytracer_torch.app.scenes import scene_cube
from tpu_raytracer_torch.parallel import compiled_render_image_sharded, spawn
from tpu_raytracer_torch.parallel.group import run_calls
from tpu_raytracer_torch.render import RenderConfig
from tpu_raytracer_torch.utils import save_png

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--world-size", type=int, default=2)
    args = ap.parse_args()
    n = args.world_size

    if args.device == "cpu":
        device, backend = "cpu", "gloo"
    elif torch.cuda.device_count() >= n:
        device, backend = None, "nccl"  # rank i on cuda:i
    else:
        device, backend = "cuda:0", "nccl" if n == 1 else "gloo"

    tensors, camera = scene_cube(args.size, device="cpu")  # moved to each rank's device
    config = RenderConfig(width=camera.width, height=camera.height)  # backend cuda: K1
    p = camera.ray_params("cpu")
    calls = [(n, functools.partial(compiled_render_image_sharded, config),
              (tensors, p["K_inv"], p["D"], p["pose"], p["inv_pose"]))]
    ranks = spawn(run_calls, n, args=(calls,), device=device, backend=backend)
    img = ranks[0][0]  # every rank holds the gathered image
    out = os.path.join(tempfile.gettempdir(), "example_torch_multichip.png")
    save_png(img.numpy(), out)
    print(f"rendered on {n} ranks ({device or 'cuda:{rank}'}, {backend}) -> {out}")
