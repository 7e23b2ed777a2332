"""Lighting the reference sketched but never enabled (raycast.cu:263-287):
cosine shading, hard shadow rays, point lights and Whitted mirror
reflections (``examples/03_lights_shadows_reflections.py``).

Run: python examples/torch/03_lights_shadows_reflections.py [--device cpu] [--size 192]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import numpy as np

from tpu_raytracer_torch.render import Camera, RenderConfig
from tpu_raytracer_torch.render.integrators import PointLight
from tpu_raytracer_torch.render.pipeline import compiled_render_image_whitted
from tpu_raytracer_torch.scene import (
    Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen,
)
from tpu_raytracer_torch.utils import save_png

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=192)
args = ap.parse_args()

scene = Scene()
scene.add_material(Material(albedo=(0.9, 0.3, 0.2)))
scene.add_material(Material(albedo=(0.9, 0.9, 0.9), reflectivity=0.6))  # mirror floor
v0, v1, v2 = procgen.icosphere(3)
scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
scene.add_mesh(objloader.loads(procgen.board_obj(12.0, 12.0)))

ball = MeshInstance(0, 0)
scene.add_mesh_instance(ball)
# board_obj faces -y; pitch it flat so it faces +z (up), 1.2 below the ball
floor = MeshInstance(1, 1)
floor.pose = np.array([0, 0, -1.2, 0, -np.pi / 2, 0], np.float32)
scene.add_mesh_instance(floor)
tensors = scene.compile(args.device)

S = args.size
camera = Camera.looking(S, S, fov_deg=55.0, pose=[0, -5, 1.0, 0, -0.15, 0])
config = RenderConfig(  # backend cuda: K3, nearest and any hit
    width=S, height=S, lighting="lambert_shadow",
    point_lights=(PointLight(position=(2.0, -2.0, 4.0), intensity=40.0),),
)
p = camera.ray_params(tensors.device)
img = compiled_render_image_whitted(config, tensors, p["K_inv"], p["D"], p["pose"],
                                    p["inv_pose"], max_bounces=2)
out = os.path.join(tempfile.gettempdir(), "example_torch_lights.png")
save_png(img.cpu().numpy(), out)
print("wrote", out)
