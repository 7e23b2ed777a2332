"""Animation through the cheap instance-update path: a pose change
updates the instance table and nothing else (the reference's
Scene::update_mesh_instance, Scene.cpp:67-74, and its disabled teapot
spin, kernel.cu:272-273; ``examples/02_animation.py``). The frames go
through ``compiled_render_image``: frame 0 captures one CUDA graph, and
frames 1-4 replay it with the new instance rows bound.

Run: python examples/torch/02_animation.py [--device cpu] [--size 128]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import numpy as np
import torch

from tpu_raytracer_torch.render import Camera, RenderConfig, compiled_render_image
from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen
from tpu_raytracer_torch.utils import save_png

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=128)
args = ap.parse_args()

scene = Scene()
mat = Material()
mat.set_texture(procgen.checkerboard_texture(64, 8))
scene.add_material(mat)
scene.add_mesh(objloader.loads(procgen.cube_obj()))
scene.add_mesh_instance(MeshInstance(0, 0))
tensors = scene.compile(args.device)

S = args.size
camera = Camera.looking(S, S, fov_deg=50.0, pose=[0, -4, 0, 0, 0, 0])
config = RenderConfig(width=S, height=S)  # backend cuda: K1
p = camera.ray_params(tensors.device)

for frame in range(5):
    spun = MeshInstance(0, 0)
    spun.pose = np.array([0, 0, 0, 0.3 * frame, 0.1 * frame, 0], np.float32)
    tensors = tensors.update_instance(0, spun)  # functional: a new instance table only
    t0 = time.perf_counter()
    img = compiled_render_image(config, tensors, p["K_inv"], p["D"], p["pose"],
                                p["inv_pose"])
    if tensors.device.type == "cuda":
        torch.cuda.synchronize(tensors.device)
    dt = time.perf_counter() - t0
    note = "  (kernel build, warm-up and capture)" if frame == 0 else ""
    print(f"frame {frame}: {dt * 1e3:.1f} ms{note}")

out = os.path.join(tempfile.gettempdir(), "example_torch_animation.png")
save_png(img.cpu().numpy(), out)
print("wrote", out)
