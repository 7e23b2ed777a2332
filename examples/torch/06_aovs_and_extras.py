"""Framework extensions: AOV buffers (depth, normal, instance), bilinear
texture filtering and supersampled anti-aliasing
(``examples/06_aovs_and_extras.py``).

Run: python examples/torch/06_aovs_and_extras.py [--device cpu] [--size 96]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
from tpu_raytracer_torch.app.scenes import scene_cube
from tpu_raytracer_torch.render import (
    RenderConfig, compiled_render_aovs, compiled_render_image,
)
from tpu_raytracer_torch.utils import save_png

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=96)
args = ap.parse_args()

S = args.size
tensors, camera = scene_cube(S, device=args.device)
p = camera.ray_params(tensors.device)
rays = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])

config = RenderConfig(
    width=S, height=S,          # backend cuda: K1
    texture_filter="bilinear",  # smooth texture lookup (4-tap lerp)
    ssaa=2,                     # 4 rays per pixel, box-averaged
)
img = compiled_render_image(config, tensors, *rays)
out = os.path.join(tempfile.gettempdir(), "example_torch_extras.png")
save_png(img.cpu().numpy(), out)

aovs = compiled_render_aovs(RenderConfig(width=S, height=S), tensors, *rays)
depth = aovs["depth"].cpu()
hit = aovs["hit"].cpu()
print(f"wrote {out}; depth range on hits: {depth[hit].min():.2f}..{depth[hit].max():.2f}")
