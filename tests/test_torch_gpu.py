"""Kernel K1 on a CUDA card against its plain PyTorch version.

Marked ``gpu``: every test skips without a card. On a machine with one
(and no JAX), run from the repository root with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py configures JAX, which this file
does not use). K1 is built with --fmad=false, so it must equal the plain
version bit for bit; the cube must equal its exact CPU golden.
"""

import os

import numpy as np
import pytest
import torch

from tpu_raytracer_torch.app.scenes import scene_cube
from tpu_raytracer_torch.kernels import traversal
from tpu_raytracer_torch.render import Camera, generate_rays, render
from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "config1_cube_64.npy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _two_instance(device):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(2)))
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.blob(subdivisions=3)))
    a = MeshInstance(0, 0)
    a.pose = np.array([-0.9, 0.0, 0.0, 0.4, 0.1, 0.0], np.float32)
    b = MeshInstance(1, 0)
    b.pose = np.array([1.1, 0.5, 0.2, 0.0, 0.3, 0.2], np.float32)
    b.scale = np.array([0.9, 1.2, 0.7], np.float32)
    scene.add_mesh_instance(a)
    scene.add_mesh_instance(b)
    cam = Camera.looking(128, 96, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])
    return scene.compile(device), cam


def _rays(cam, device):
    p = cam.ray_params(device)
    return generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])


@pytest.mark.parametrize("which", ["cube", "two_instance"])
def test_k1_matches_plain_version_bitwise(cuda, which):
    scene, cam = scene_cube(64, device=cuda) if which == "cube" else _two_instance(cuda)
    o, d = _rays(cam, cuda)
    before = traversal.LAUNCHES
    got = traversal.cast_rays_cuda(scene, o, d)
    torch.cuda.synchronize()
    assert traversal.LAUNCHES == before + 1
    want = traversal.cast_rays_wide_torch(scene, o, d)
    assert (got.tri >= 0).any()
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.inst, want.inst)
    per_ray = traversal.cast_rays_cuda(scene, o.expand(d.shape).contiguous(), d)
    assert torch.equal(per_ray.t, got.t) and torch.equal(per_ray.tri, got.tri)


def test_cube_render_matches_cpu_golden(cuda):
    scene, cam = scene_cube(64, device=cuda)
    img = render(cam, scene, backend="cuda")
    assert img.device.type == "cuda"
    np.testing.assert_array_equal(img.cpu().numpy(), np.load(GOLDEN))


def test_wrapper_rejects_bad_inputs(cuda):
    scene, cam = scene_cube(64, device=cuda)
    o, d = _rays(cam, cuda)
    with pytest.raises(ValueError):
        traversal.cast_rays_cuda(scene, o, d.transpose(0, 1))
    with pytest.raises(ValueError):
        traversal.cast_rays_cuda(scene, o.cpu(), d)
    with pytest.raises(ValueError):
        traversal.cast_rays_cuda(scene.to("cpu"), o, d)
