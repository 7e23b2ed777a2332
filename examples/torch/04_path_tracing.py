"""Monte-Carlo path tracing with emissive materials: the stochastic
bounce design the reference's curand setup anticipated
(raycast.cu:190-193) but never ran (``examples/04_path_tracing.py``).

Run: python examples/torch/04_path_tracing.py [--device cpu] [--size 128]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
from tpu_raytracer_torch.app.scenes import scene_cornell
from tpu_raytracer_torch.render import RenderConfig
from tpu_raytracer_torch.render.pipeline import compiled_render_image_path_traced
from tpu_raytracer_torch.utils import prng, save_png

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=128)
args = ap.parse_args()

tensors, camera = scene_cornell(args.size, device=args.device)
config = RenderConfig(width=camera.width, height=camera.height)  # backend cuda: K3
p = camera.ray_params(tensors.device)
img = compiled_render_image_path_traced(config, tensors, p["K_inv"], p["D"], p["pose"],
                                        p["inv_pose"], prng.PRNGKey(0, device=tensors.device),
                                        max_bounces=3, samples=4)
out = os.path.join(tempfile.gettempdir(), "example_torch_path.png")
save_png(img.cpu().numpy(), out)
print("wrote", out)
