"""The port's scene layer (tpu_raytracer_torch.scene, kernels/wide4.py)
against the JAX package's, on the same recipes.

Host-numpy fields must be identical. ``inst_inv_pose`` goes through each
package's own transforms (sin/cos/atan2 of two libraries) and is held to
rtol 1e-6 / atol 1e-7. The K1 triangle records equal the JAX kernel's
packed records bit for bit (NaN lanes of the zero padding triangles
included).

The scene recipes below are shared with the other test_torch_* files.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
import tpu_raytracer.scene as js
import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer.kernels.traversal import _scene_kernel_inputs
from tpu_raytracer_torch.scene.scene import ARRAY_FIELDS, from_scene_arrays

torch.set_num_threads(1)

PACKAGES = {"jax": (js, jr), "torch": (ts, tr)}


def _cube(S, R, tex=128):
    """BASELINE config 1 (app/scenes.py scene_cube at 64x64); tex=64 is
    tests/test_render.py's textured cube_scene."""
    scene = S.Scene()
    mat = S.Material()
    mat.set_texture(S.procgen.checkerboard_texture(tex, 8))
    scene.add_material(mat)
    scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
    scene.add_mesh_instance(S.MeshInstance(0, 0))
    cam = R.Camera.looking(64, 64, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene, cam


def _two_instance(S, R):
    """tests/test_pallas_interpret.py's posed, non-uniformly scaled pair."""
    scene = S.Scene()
    scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2)))
    mat = S.Material()
    mat.set_texture(S.procgen.checkerboard_texture(32, 4))
    scene.add_material(mat)
    scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
    scene.add_mesh(S.MeshPrimitive.from_triangles(*S.procgen.icosphere(2)))
    a = S.MeshInstance(0, 1)
    a.pose = np.array([-0.9, 0.0, 0.0, 0.4, 0.1, 0.0], np.float32)
    b = S.MeshInstance(1, 0)
    b.pose = np.array([1.1, 0.5, 0.2, 0.0, 0.3, 0.2], np.float32)
    b.scale = np.array([0.9, 1.2, 0.7], np.float32)
    scene.add_mesh_instance(a)
    scene.add_mesh_instance(b)
    cam = R.Camera.looking(64, 64, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])
    return scene, cam


def _blob(S, R, subdivisions=4):
    """The flagship's mesh (BASELINE config 3) at a CPU-sized subdivision."""
    scene = S.Scene()
    scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2)))
    scene.add_mesh(S.MeshPrimitive.from_triangles(
        *S.procgen.blob(subdivisions=subdivisions)))
    scene.add_mesh_instance(S.MeshInstance(0, 0))
    cam = R.Camera.looking(64, 64, fov_deg=50.0, pose=[0.0, -3.2, 0.13, 0, 0, 0])
    return scene, cam


RECIPES = {
    "cube": _cube,
    "cube_tex64": functools.partial(_cube, tex=64),
    "two_instance": _two_instance,
    "blob3": functools.partial(_blob, subdivisions=3),
    "blob4": _blob,
}


@functools.lru_cache(maxsize=None)
def compiled(name: str, pkg: str):
    """(compiled scene, camera) of recipe ``name`` built by package ``pkg``."""
    scene, cam = RECIPES[name](*PACKAGES[pkg])
    return (scene.compile(device="cpu") if pkg == "torch" else scene.compile()), cam


def jax_fields(arrays) -> dict:
    return {f.name: np.asarray(getattr(arrays, f.name))
            for f in dataclasses.fields(arrays) if f.name in ARRAY_FIELDS}


@functools.lru_cache(maxsize=None)
def jax_rays(name: str):
    """The JAX package's primary rays for recipe ``name``: (origin [3],
    directions [H, W, 3]) as numpy."""
    _, cam = compiled(name, "jax")
    p = cam.ray_params()
    o, d = jr.generate_rays(cam.width, cam.height, p["K_inv"], p["D"],
                            p["pose"], p["inv_pose"])
    return np.asarray(o), np.asarray(d)


SCENE_NAMES = ("cube", "two_instance", "blob3")


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_compile_matches_jax(name):
    ja, _ = compiled(name, "jax")
    pa, _ = compiled(name, "torch")
    for field in ARRAY_FIELDS:
        want = np.asarray(getattr(ja, field))
        got = getattr(pa, field).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, field
        if field == "inst_inv_pose":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    for flag in ("has_sky", "has_textures", "has_emissive"):
        assert getattr(pa, flag) == getattr(ja, flag), flag


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_wide_tables_match_jax(name):
    ja, _ = compiled(name, "jax")
    w = compiled(name, "torch")[0].wide4
    n = w.wcode.shape[0]
    np.testing.assert_array_equal(w.wcode.numpy(), np.asarray(ja.wide4.wcode).reshape(n, 4))
    np.testing.assert_array_equal(
        w.wbox.numpy(), np.asarray(ja.wide4.wnodef).reshape(-1, 32)[:n])
    np.testing.assert_array_equal(w.wroot.numpy(), np.asarray(ja.wide4.wroot))
    assert w.max_leaf == ja.wide4.max_leaf
    assert 3 * w.depth + 4 <= 192


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_tri_records_match_jax_kernel_records(name):
    """Exactly equal: v0, n, rA, rB (barycentric_rows in both packages,
    no FMA contraction on either side) and the zero lanes."""
    ja, _ = compiled(name, "jax")
    got = compiled(name, "torch")[0].wide4.tri_rec.numpy()
    trif = np.asarray(_scene_kernel_inputs(ja)[2][0]).reshape(-1, 16)[:got.shape[0]]
    np.testing.assert_array_equal(got.view(np.int32), trif.view(np.int32))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_from_scene_arrays_roundtrips(name):
    ja, _ = compiled(name, "jax")
    pa, _ = compiled(name, "torch")
    for src in (jax_fields(ja), pa.numpy_fields()):
        back = from_scene_arrays(src, device="cpu")
        for field in ARRAY_FIELDS:
            np.testing.assert_array_equal(back.numpy_fields()[field], src[field],
                                          err_msg=field)
        np.testing.assert_array_equal(back.wide4.wcode.numpy(), pa.wide4.wcode.numpy())
        np.testing.assert_array_equal(back.wide4.wbox.numpy(), pa.wide4.wbox.numpy())
        assert back.has_textures == pa.has_textures


@pytest.mark.parametrize("fn,args", [
    ("cube_obj", ()),
    ("cube_obj", (0.6, False)),
    ("board_obj", (8, 8)),
    ("icosphere", (3,)),
    ("blob", (3,)),
    ("checkerboard_texture", (64, 8)),
])
def test_procgen_matches_jax(fn, args):
    want = getattr(js.procgen, fn)(*args)
    got = getattr(ts.procgen, fn)(*args)
    if isinstance(want, str):
        assert got == want
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w_ in zip(got, want, strict=True):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("text", [
    js.procgen.cube_obj(),
    js.procgen.board_obj(2, 3),
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 1\nf 1/1 2 3/2 4\n",
])
def test_objloader_matches_jax(text):
    from tpu_raytracer.scene.objloader import _parse_obj_py

    for g, w_ in zip(ts.objloader.parse_obj(text), _parse_obj_py(text)):
        np.testing.assert_array_equal(g, w_)


def test_scene_moves_between_devices_and_keeps_tables():
    pa, _ = compiled("cube", "torch")
    moved = pa.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.wide4.depth == pa.wide4.depth
    np.testing.assert_array_equal(moved.wide4.tri_rec.numpy(), pa.wide4.tri_rec.numpy())
