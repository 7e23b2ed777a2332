"""The port's examples (``examples/torch/``) stay runnable: each compiles,
and each runs in a subprocess on the CPU at 64x64 (``--device cpu --size
64``; ``05_multichip`` on two gloo ranks), exits 0 and prints the path of
the PNG it wrote, which holds a 64x64 image that is not one colour. The
examples render through the compiled entry points: the PNGs of
``02_animation`` and ``04_path_tracing`` are bitwise the eager frames of
their scenes rendered here."""

import os
import py_compile
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_raytracer_torch.utils.image import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(ROOT, "examples", "torch")
EXAMPLES = sorted(f for f in os.listdir(DIR) if f.endswith(".py"))
SIZE = 64

@pytest.fixture(scope="module")
def written_png(tmp_path_factory):
    """The image an example wrote, each example run once per module in a
    subprocess with ``TMPDIR`` a folder of its own."""
    runs = {}

    def png(name: str) -> np.ndarray:
        if name not in runs:
            tmp = tmp_path_factory.mktemp(name[:2])
            extra = ["--world-size", "2"] if name.startswith("05") else []
            env = dict(os.environ, TMPDIR=str(tmp))
            runs[name] = (subprocess.run(
                [sys.executable, os.path.join(DIR, name), "--device", "cpu", "--size",
                 str(SIZE), *extra], capture_output=True, text=True, timeout=300, env=env,
                cwd=ROOT), tmp)
        r, tmp = runs[name]
        assert r.returncode == 0, r.stderr[-2000:]
        m = re.search(r"(\S*example_torch_\w+\.png)", r.stdout)
        assert m, r.stdout
        assert os.path.dirname(m.group(1)) == str(tmp)
        return read_png(m.group(1))

    return png


def test_all_examples_compile():
    assert [f[:3] for f in EXAMPLES] == [f"{i:02d}_" for i in range(1, 7)]
    for f in EXAMPLES:
        py_compile.compile(os.path.join(DIR, f), doraise=True)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, written_png):
    img = written_png(name)
    assert img.shape == (SIZE, SIZE, 3) and (img != img[0, 0]).any()


def _animation_frame() -> torch.Tensor:
    """``02_animation.py``'s last frame, rendered eagerly."""
    from tpu_raytracer_torch.render import Camera, RenderConfig, render_image
    from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen

    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(64, 8))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    tensors = scene.compile("cpu")
    spun = MeshInstance(0, 0)
    spun.pose = np.array([0, 0, 0, 0.3 * 4, 0.1 * 4, 0], np.float32)
    tensors = tensors.update_instance(0, spun)
    p = Camera.looking(SIZE, SIZE, fov_deg=50.0, pose=[0, -4, 0, 0, 0, 0]).ray_params("cpu")
    return render_image(RenderConfig(SIZE, SIZE), tensors, p["K_inv"], p["D"], p["pose"],
                        p["inv_pose"])


def _path_frame() -> torch.Tensor:
    """``04_path_tracing.py``'s frame, rendered eagerly."""
    from tpu_raytracer_torch.app.scenes import scene_cornell
    from tpu_raytracer_torch.render import RenderConfig
    from tpu_raytracer_torch.render.pipeline import render_image_path_traced
    from tpu_raytracer_torch.utils import prng

    tensors, camera = scene_cornell(SIZE, device="cpu")
    p = camera.ray_params("cpu")
    return render_image_path_traced(RenderConfig(camera.width, camera.height), tensors,
                                    p["K_inv"], p["D"], p["pose"], p["inv_pose"],
                                    prng.PRNGKey(0), max_bounces=3, samples=4)


@pytest.mark.parametrize("name,eager", [("02_animation.py", _animation_frame),
                                        ("04_path_tracing.py", _path_frame)])
def test_example_png_is_the_eager_frame(name, eager, written_png):
    img = written_png(name)
    np.testing.assert_array_equal(img, eager().numpy())
