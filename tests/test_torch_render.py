"""The port's primary-ray render path end to end on the CPU.

Images are compared exactly: config 1 against the goldens the JAX
package rendered on the CPU (tests/golden/*.npy), and the flagship mesh
at 64x64 against the JAX ``bvh`` render. On the CPU the ``cuda`` backend
runs kernel K1's plain version. A subprocess shows the port renders with
JAX unimportable.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
from tpu_raytracer_torch.app import scenes as port_scenes
from tpu_raytracer_torch.render import RenderConfig, render, render_image
from tpu_raytracer_torch.scene import from_scene_arrays
from tpu_raytracer_torch.utils import encode_png

from test_torch_scene import compiled

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("recipe,golden", [
    ("cube", "config1_cube_64"),  # app/scenes.py scene_cube(64)
    ("cube_tex64", "cube_64"),  # tests/test_render.py cube_scene(textured=True)
])
@pytest.mark.parametrize("backend", ["cuda", "brute"])
def test_render_matches_cpu_golden(recipe, golden, backend):
    scene, cam = compiled(recipe, "torch")
    img = render(cam, scene, backend=backend)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (64, 64, 3)
    np.testing.assert_array_equal(img.numpy(), np.load(os.path.join(GOLDEN_DIR, golden + ".npy")))


def test_app_scene_cube_is_config1():
    scene, cam = port_scenes.scene_cube(64, device="cpu")
    img = render(cam, scene)
    np.testing.assert_array_equal(
        img.numpy(), np.load(os.path.join(GOLDEN_DIR, "config1_cube_64.npy")))


def test_flagship_mesh_matches_jax_bvh_render():
    """blob subdivision 4 (~5k triangles), 64x64, flat: the flagship's
    route at a CPU size, against the JAX package's XLA BVH walk."""
    ja, jcam = compiled("blob4", "jax")
    pa, pcam = compiled("blob4", "torch")
    p = jcam.ray_params()
    want = np.asarray(jr.render_image(jr.RenderConfig(64, 64, backend="bvh"), ja,
                                      p["K_inv"], p["D"], p["pose"], p["inv_pose"]))
    q = pcam.ray_params(device="cpu")
    got = render_image(RenderConfig(64, 64, backend="cuda"), pa,
                       q["K_inv"], q["D"], q["pose"], q["inv_pose"])
    np.testing.assert_array_equal(got.numpy(), want)
    hit = (want != np.array([255, 204, 153], np.uint8)).any(-1).mean()
    assert 0.2 < hit < 0.9


def test_render_runs_without_jax(tmp_path):
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from tpu_raytracer_torch.app.scenes import scene_cube\n"
        "from tpu_raytracer_torch.render import render\n"
        "scene, cam = scene_cube(64, device='cpu')\n"
        "img = render(cam, scene, backend='cuda').numpy()\n"
        f"assert (img == np.load({os.path.join(GOLDEN_DIR, 'config1_cube_64.npy')!r})).all()\n"
        "assert sys.modules['jax'] is None\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_driver_writes_png_and_rejects_demo(tmp_path, capsys, monkeypatch):
    from tpu_raytracer_torch.app import driver
    from tpu_raytracer_torch.app.driver import run
    from tpu_raytracer_torch.utils import overlay_fps

    fps = []  # the FPS the driver burns into out.png
    monkeypatch.setattr(driver, "overlay_fps", lambda im, f: fps.append(f) or overlay_fps(im, f))
    out = tmp_path / "cube.png"
    img = run("cube", 64, 64, frames=2, out=str(out), device="cpu")
    assert capsys.readouterr().out.count("FPS:") == 2
    assert out.read_bytes() == encode_png(overlay_fps(img.numpy(), fps[-1]))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the default scene is the two-instance demo, which routes to K3
    demo = run(out=str(out), width=32, height=32, frames=1, device="cpu")
    assert tuple(demo.shape) == (32, 32, 3)
    assert (demo.numpy() != np.array([255, 204, 153], np.uint8)).any()


def test_unported_routes_raise():
    scene, cam = compiled("cube", "torch")
    with pytest.raises(NotImplementedError, match="bvh, cuda"):
        render(cam, scene, backend="pallas")
    with pytest.raises(ValueError, match="texture filter"):
        render(cam, scene, texture_filter="anisotropic")
    # sky maps and vertex normals are ported: a zero tri_vnorm (no face
    # has vertex normals) renders the face-normal image
    fields = scene.numpy_fields()
    fields["tri_vnorm"] = np.zeros((scene.num_triangles, 10), np.float32)
    flat = from_scene_arrays(fields, device="cpu")
    assert flat.tri_vnorm is not None
    assert torch.equal(render(cam, flat, lighting="lambert"),
                       render(cam, scene, lighting="lambert"))
