"""The compiled entry points (``render/compiled.py``, the jit boundary) on
the CPU, where they run the binding path with no capture.

  * Each compiled entry point equals its eager function bit for bit, and
    matches the CPU goldens as the eager one does: configs 1-4 exactly,
    config 5 within ``GOLDEN5_MAX_MISMATCH`` pixels (the bound of
    ``test_torch_path.py``).
  * A new pose, an ``update_instance`` (with the TLAS it rebuilds) and a
    new key reuse the entry and give the new frame, so an input that is
    not copied into the entry's buffers shows as a stale frame.
  * A changed static config, a new resolution and a new scene of the same
    shapes each make an entry of their own, and the new scene renders its
    own frame.
  * The compiled ``render_image`` equals the JAX package's jitted
    ``render_image`` on the textured cube at 64x64 through ``brute`` and
    ``bvh``, exactly, as the goldens tests compare.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
from tpu_raytracer_torch.app import driver, interactive
from tpu_raytracer_torch.app import scenes as port_scenes
from tpu_raytracer_torch.app.web import WebViewer
from tpu_raytracer_torch.render import RenderConfig, pipeline
from tpu_raytracer_torch.render.compiled import INSTANCE_FIELDS, CompiledFrame
from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen
from tpu_raytracer_torch.utils import prng

from test_torch_path import GOLDEN5_MAX_MISMATCH
from test_torch_scene import compiled

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def no_entries():
    pipeline.clear_compiled()
    yield
    pipeline.clear_compiled()


def cam_args(cam) -> tuple:
    p = cam.ray_params("cpu")
    return p["K_inv"], p["D"], p["pose"], p["inv_pose"]


def golden(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_DIR, name + ".npy"))


def both(name: str, *args, **kw):
    """(compiled frame, eager frame) of entry point ``name``."""
    eager = getattr(pipeline, name)
    fast = getattr(pipeline, "compiled_" + name)
    return fast(*args, **kw), eager(*args, **kw)


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                       b.view(torch.uint8) if b.dtype != torch.bool else b)


# -- equal to the eager frames and the goldens --------------------------------

def _config1():
    scene, cam = port_scenes.scene_cube(64, device="cpu")
    return "render_image", RenderConfig(64, 64), scene, cam


def _cube_tex():
    scene, cam = compiled("cube_tex64", "torch")
    return "render_image", RenderConfig(64, 64), scene, cam


def _config2():
    scene, cam = port_scenes.scene_cornell(64, device="cpu")
    return "render_image", RenderConfig(64, 64, lighting="lambert_shadow"), scene, cam


def _config3():
    scene, cam = port_scenes.scene_bunny(96, 96, subdivisions=4, device="cpu")
    return "render_image", RenderConfig(96, 96, lighting="blinn_phong"), scene, cam


def _config4():
    scene, cam = port_scenes.scene_instances(64, 64, device="cpu")
    return "render_image_whitted", RenderConfig(64, 64), scene, cam


@pytest.mark.parametrize("name,recipe", [
    ("config1_cube_64", _config1), ("cube_64", _cube_tex),
    ("config2_cornell_64", _config2),  # K3 + any-hit shadows
    ("config3_bunny_96", _config3),  # K1, Blinn-Phong
    ("config4_instances_whitted_64", _config4),  # K3, 3 bounces + shadows
])
def test_compiled_frame_is_the_eager_frame_and_the_golden(name, recipe):
    fn, config, scene, cam = recipe()
    got, want = both(fn, config, scene, *cam_args(cam))
    assert_same(got, want)
    np.testing.assert_array_equal(got.numpy(), golden(name))
    entry = getattr(pipeline, "compiled_" + fn).last
    assert entry.device == torch.device("cpu") and entry.graph is None  # no capture on the CPU
    # the entry holds the scene's bound tables, not copies
    assert entry.args[1].tri_rec is scene.tri_rec and entry.args[1].wide4 is scene.wide4


def test_compiled_path_frame_matches_config5_golden():
    scene, cam = port_scenes.scene_colonnade(64, 64, columns=4, segs=8, device="cpu")
    got, want = both("render_image_path_traced", RenderConfig(64, 64, backend="bvh"), scene,
                     *cam_args(cam), prng.PRNGKey(7), 2, 2)
    assert_same(got, want)
    mismatch = int((got.numpy() != golden("config5_colonnade_path_64")).any(-1).sum())
    assert mismatch <= GOLDEN5_MAX_MISMATCH


def test_aovs_ao_and_radiance_are_the_eager_ones():
    scene, cam = port_scenes.scene_cornell(24, device="cpu")
    args = (RenderConfig(24, 24), scene, *cam_args(cam))
    key = prng.PRNGKey(3)
    for name, extra, kw in (
        ("render_aovs", (), {}),
        ("render_image_ao", (key,), {"samples": 2, "radius": 0.5}),
        ("render_radiance_path_traced", (key,), {"max_bounces": 1, "samples": 2}),
        ("render_image_path_traced", (key, 1, 2), {"lens_radius": 0.05}),
    ):
        assert_same(*both(name, *args, *extra, **kw))
    # the supersampled frame binds the same inputs
    assert_same(*both("render_image", RenderConfig(12, 12, ssaa=2), scene, *cam_args(cam)))


@pytest.mark.parametrize("backend", ["cuda", "bvh"])
def test_a_routed_big_scene_frame_is_the_eager_frame(backend, monkeypatch):
    """A scene past the paging limit (lowered to 64 rows, as in
    ``test_torch_bigscene.py``): ``cuda`` and ``bvh`` cast it through K4's
    route inside the compiled frame as in the eager one."""
    from tpu_raytracer_torch.kernels import traversal

    monkeypatch.setattr(traversal, "PAGING_ROWS", 64)
    scene, cam = port_scenes.scene_colonnade(16, 16, columns=2, segs=8, device="cpu")
    assert scene.needs_paging() and scene.wide4 is None
    for name, config in (
        ("render_image", RenderConfig(16, 16, backend=backend, lighting="lambert_shadow")),
        ("render_image_whitted", RenderConfig(16, 16, backend=backend)),
    ):
        assert_same(*both(name, config, scene, *cam_args(cam)))


# -- runtime inputs reuse the entry -------------------------------------------

def test_a_new_pose_reuses_the_entry():
    scene, cam = port_scenes.scene_instances(32, 32, device="cpu")
    config = RenderConfig(32, 32)
    first = pipeline.compiled_render_image_whitted(config, scene, *cam_args(cam))
    cam.pose = cam.pose + np.array([0.3, 0.2, 0.1, 0.05, 0.0, 0.0], np.float32)
    got, want = both("render_image_whitted", config, scene, *cam_args(cam))
    assert len(pipeline.compiled_render_image_whitted.entries) == 1
    assert_same(got, want)
    assert not torch.equal(got, first)


def test_an_instance_update_reuses_the_entry():
    """Config 4's four instances: the moved instance's rows and the TLAS
    ``update_instance`` rebuilds are runtime inputs."""
    scene, cam = port_scenes.scene_instances(32, 32, device="cpu")
    config = RenderConfig(32, 32)
    first = pipeline.compiled_render_image(config, scene, *cam_args(cam))
    moved = MeshInstance(scene.inst_mesh[1].item(), scene.inst_material[1].item())
    moved.pose = np.array([0.4, -0.3, 0.2, 0.6, 0.0, 0.0], np.float32)
    moved.scale = np.array([1.2, 1.2, 1.2], np.float32)
    updated = scene.update_instance(1, moved)
    assert updated.tlas is not scene.tlas and updated.wide4 is scene.wide4
    got, want = both("render_image", config, updated, *cam_args(cam))
    assert len(pipeline.compiled_render_image.entries) == 1
    assert_same(got, want)
    assert not torch.equal(got, first)
    entry = pipeline.compiled_render_image.last
    for f in INSTANCE_FIELDS:
        assert torch.equal(getattr(entry.args[1], f), getattr(updated, f))
    assert torch.equal(entry.args[1].tlas.box, updated.tlas.box)
    # back to the first scene: the same entry, the first frame
    assert_same(pipeline.compiled_render_image(config, scene, *cam_args(cam)), first)
    assert len(pipeline.compiled_render_image.entries) == 1


def test_a_new_key_reuses_the_entry():
    scene, cam = port_scenes.scene_cornell(16, device="cpu")
    args = (RenderConfig(16, 16), scene, *cam_args(cam))
    frames = []
    for seed in (1, 2):
        got, want = both("render_image_path_traced", *args, prng.PRNGKey(seed), 1, 2)
        assert_same(got, want)
        frames.append(got)
        assert_same(*both("render_image_ao", *args, key=prng.PRNGKey(seed), samples=2))
    assert len(pipeline.compiled_render_image_path_traced.entries) == 1
    assert len(pipeline.compiled_render_image_ao.entries) == 1
    assert not torch.equal(*frames)


# -- static configs, resolutions and scenes make entries ----------------------

def _cube(checks: int):
    """``scene_cube``'s scene with ``checks`` checker squares a side."""
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(128, checks))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene.compile("cpu")


def test_static_config_resolution_and_scene_make_their_own_entries():
    scene, cam = port_scenes.scene_cube(16, device="cpu")
    frame = pipeline.compiled_render_image
    frame(RenderConfig(16, 16), scene, *cam_args(cam))
    frame(RenderConfig(16, 16), scene, *cam_args(cam))
    assert len(frame.entries) == 1
    frame(RenderConfig(16, 16, lighting="lambert"), scene, *cam_args(cam))
    assert len(frame.entries) == 2
    cam8 = dataclasses.replace(cam, width=8, height=8)
    frame(RenderConfig(8, 8), scene, *cam_args(cam8))
    assert len(frame.entries) == 3
    # the same shapes, other tables: a scene of its own renders its own frame
    other = _cube(checks=4)
    assert [x.shape for x in other.numpy_fields().values()] == \
        [x.shape for x in scene.numpy_fields().values()]
    got = frame(RenderConfig(16, 16), other, *cam_args(cam))
    assert len(frame.entries) == 4
    assert_same(got, pipeline.render_image(RenderConfig(16, 16), other, *cam_args(cam)))
    assert not torch.equal(got, frame(RenderConfig(16, 16), scene, *cam_args(cam)))
    assert len(frame.entries) == 4
    # a static argument passed by keyword or position, in any order
    whitted = pipeline.compiled_render_image_whitted
    a = whitted(RenderConfig(16, 16), scene, *cam_args(cam), shadows=False, max_bounces=1)
    b = whitted(RenderConfig(16, 16), scene, *cam_args(cam), max_bounces=1, shadows=False)
    assert_same(a, b)
    assert len(whitted.entries) == 1
    with pytest.raises(TypeError, match="hashable"):
        CompiledFrame(pipeline.render_image)(RenderConfig(16, 16), scene, *cam_args(cam),
                                             [1, 2])
    frame.clear()
    assert not frame.entries and frame.last is None


def test_callers_render_through_the_compiled_entries(tmp_path):
    """The driver, both viewers and their frames go through the compiled
    entry points, one entry per static config across their frames."""
    img = driver.run("cube", 16, 16, frames=2, out=str(tmp_path / "d.png"), device="cpu")
    assert len(pipeline.compiled_render_image.entries) == 1
    scene, cam = port_scenes.scene_cube(16, device="cpu")
    assert_same(img, pipeline.render_image(RenderConfig(16, 16), scene, *cam_args(cam)))
    pipeline.clear_compiled()
    interactive.run_interactive("cube", 16, 16, keys=iter("wd"), out=str(tmp_path / "i.png"),
                                device="cpu")
    assert len(pipeline.compiled_render_image.entries) == 1
    viewer = WebViewer(scene, cam, RenderConfig(16, 16), mode="ao")
    viewer.render_u8()
    viewer.render_u8()
    assert len(pipeline.compiled_render_image_ao.entries) == 1


# -- against the JAX package's jit ---------------------------------------------

@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_compiled_render_image_matches_jax_jit(backend):
    ja, jcam = compiled("cube_tex64", "jax")
    pa, pcam = compiled("cube_tex64", "torch")
    p = jcam.ray_params()
    want = np.asarray(jr.render_image(jr.RenderConfig(64, 64, backend=backend), ja,
                                      p["K_inv"], p["D"], p["pose"], p["inv_pose"]))
    got = pipeline.compiled_render_image(RenderConfig(64, 64, backend=backend), pa,
                                         *cam_args(pcam))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), golden("cube_64"))
