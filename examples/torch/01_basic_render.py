"""Minimal end-to-end render on the PyTorch/CUDA port: build a scene,
compile it onto the card, render one frame, save a PNG (the reference's
kernel.cu:141-302 demo, distilled; ``examples/01_basic_render.py``).

Run: python examples/torch/01_basic_render.py [--device cpu] [--size 256]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import numpy as np

from tpu_raytracer_torch.render import Camera, render
from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen
from tpu_raytracer_torch.utils import save_png

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=256)
args = ap.parse_args()

scene = Scene()
scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
checker = Material()
checker.set_texture(procgen.checkerboard_texture(128, 16))
scene.add_material(checker)

scene.add_mesh(objloader.loads(procgen.cube_obj()))

blue = MeshInstance(0, 0)
blue.pose = np.array([-1.2, 0.0, 0.0, 0.3, 0.2, 0.0], np.float32)
scene.add_mesh_instance(blue)
tex = MeshInstance(0, 1)
tex.pose = np.array([1.2, 0.5, 0.0, -0.2, 0.0, 0.1], np.float32)
scene.add_mesh_instance(tex)

tensors = scene.compile(args.device)  # flat tables on the device, BVH built and packed

camera = Camera.looking(args.size, args.size, fov_deg=60.0, pose=[0, -5, 0.5, 0, 0, 0])
# backend cuda: K3; render() goes through compiled_render_image (one CUDA graph)
img = render(camera, tensors, lighting="lambert").cpu().numpy()
out = os.path.join(tempfile.gettempdir(), "example_torch_basic.png")
save_png(img, out)
print("wrote", out, img.shape, img.dtype)
