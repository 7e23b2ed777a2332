"""The port's presplit (``accel/presplit.py``), reference build
(``build_bvh(refs=...)``) and reinsertion optimizer (``accel/optimize.py``)
against the JAX package's, and the kernels' plain versions on the trees
they make.

Meshes are the JAX package's own test meshes (``tests/test_presplit.py``,
``tests/test_optimize.py``): ``procgen.blob(subdivisions=3)`` (1,280
uniform triangles: nothing to split) and ``procgen.colonnade(3, 3, 8,
bands=8)`` (1,154 triangles under a few large floor and ceiling slabs).
All of this is numpy f32 on both sides in the same order of operations,
so every array must be equal, not close. The plain casts (K1, K2 and the
paged K4-K6) on presplit and optimized trees must agree with the brute
cast in t to 1e-5 (the brute cast's plane math is not the kernels'
triangle test), and where they do not, or where they differ from K1 on
the plain tree, the difference must be one the order of box tests
explains (``traversal.unexplained_differences``).
"""

import numpy as np
import pytest
import torch

from tpu_raytracer.accel.bvh import build_bvh as jax_build_bvh
from tpu_raytracer.accel.bvh import sah_cost as jax_sah_cost
from tpu_raytracer.accel.optimize import optimize_bvh as jax_optimize_bvh
from tpu_raytracer.accel.presplit import presplit_refs as jax_presplit_refs
from tpu_raytracer.scene import procgen as jax_procgen
from tpu_raytracer.scene.mesh import MeshPrimitive as JaxMesh
from tpu_raytracer.scene.mesh import _paged_only_size
from tpu_raytracer_torch.accel.bvh import build_bvh, sah_cost
from tpu_raytracer_torch.accel.optimize import optimize_bvh
from tpu_raytracer_torch.accel.presplit import presplit_refs
from tpu_raytracer_torch.kernels import binary, paged, paged_major, traversal
from tpu_raytracer_torch.render import Camera, generate_rays
from tpu_raytracer_torch.render.renderer import cast_rays_brute
from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, mesh, procgen

from test_optimize import _check_invariants
from test_torch_accel import assert_same_bvh

torch.set_num_threads(1)

MESHES = {"blob": lambda: procgen.blob(subdivisions=3),
          "colonnade": lambda: procgen.colonnade(3, 3, 8, bands=8)}
BRUTE_RTOL = 1e-5


def test_procgen_meshes_equal_jax():
    for name, make in MESHES.items():
        jmake = {"blob": lambda: jax_procgen.blob(subdivisions=3),
                 "colonnade": lambda: jax_procgen.colonnade(3, 3, 8, bands=8)}[name]
        for a, b in zip(make(), jmake()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budget", [0.15, 0.3, 1.3])
def test_presplit_refs_match_jax(budget):
    v = MESHES["colonnade"]()
    got = presplit_refs(*v, budget_factor=budget)
    want = jax_presplit_refs(*v, budget_factor=budget)
    assert got is not None and len(got[0]) > len(v[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_presplit_leaves_uniform_meshes_alone():
    v = MESHES["blob"]()
    assert presplit_refs(*v) is None and jax_presplit_refs(*v) is None
    assert presplit_refs(*v, budget_factor=1.3) is None


@pytest.mark.parametrize("mode", ["sweep", "reference"])
def test_build_with_refs_matches_jax(mode):
    v = MESHES["colonnade"]()
    refs = presplit_refs(*v, budget_factor=0.3)
    got = build_bvh(*v, min_leaf_size=16, mode=mode, refs=refs)
    want = jax_build_bvh(*v, min_leaf_size=16, mode=mode, refs=refs)
    assert_same_bvh(got, want)
    assert len(got.order) == len(refs[0])
    assert set(got.order.tolist()) == set(range(len(v[0])))  # every triangle, duplicated
    assert sah_cost(got) == jax_sah_cost(want)


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_optimize_matches_jax(name, rounds):
    v = MESHES[name]()
    tree = build_bvh(*v, min_leaf_size=16, mode="sweep")
    got = optimize_bvh(tree, rounds=rounds)
    want = jax_optimize_bvh(jax_build_bvh(*v, min_leaf_size=16, mode="sweep"), rounds=rounds)
    assert_same_bvh(got, want)
    assert sah_cost(got) == jax_sah_cost(want)
    _check_invariants(got, len(v[0]))
    assert sah_cost(got) <= sah_cost(tree) * (1 + 1e-6)
    if name == "colonnade":
        assert sah_cost(got) < sah_cost(tree)


def test_optimize_respects_the_depth_cap_as_jax_does():
    v = procgen.blob(subdivisions=4)
    tree = build_bvh(*v, min_leaf_size=16, mode="sweep")
    cap = tree.stats()["max_depth"] + 3
    got = optimize_bvh(tree, rounds=3, max_depth=cap)
    assert got.stats()["max_depth"] <= cap
    assert_same_bvh(got, jax_optimize_bvh(tree, rounds=3, max_depth=cap))
    assert got.stats() == tree.stats() | {"max_depth": got.stats()["max_depth"]}


# (port from_triangles options, JAX builder, JAX environment) giving the
# same tree and arrays
MESH_OPTIONS = {
    "auto": ({}, "auto", {}),
    "numpy": ({"builder": "numpy"}, "numpy", {}),
    "native_reference_tree": ({"builder": "native"}, "numpy", {"TRT_BVH_SWEEP": "0"}),
    "presplit": ({"presplit": 0.3}, "auto", {"TRT_BVH_PRESPLIT": "0.3"}),
    "presplit_gate": ({"presplit": 1.3, "presplit_gate": 4.0}, "auto",
                      {"TRT_BVH_PRESPLIT": "1.3", "TRT_PRESPLIT_GATE": "4"}),
    "presplit_reference": ({"presplit": 0.3, "builder": "native"}, "numpy",
                           {"TRT_BVH_PRESPLIT": "0.3", "TRT_BVH_SWEEP": "0"}),
    "opt2": ({"opt_rounds": 2}, "auto", {"TRT_BVH_OPT": "2"}),
    "q_rsqrt_normals": ({"exact_normals": False}, "auto", {}),
}


@pytest.mark.parametrize("option", sorted(MESH_OPTIONS))
def test_mesh_build_options_match_jax(monkeypatch, option):
    port_kw, jax_builder, env = MESH_OPTIONS[option]
    for k in ("TRT_BVH_SWEEP", "TRT_BVH_OPT", "TRT_BVH_PRESPLIT", "TRT_PRESPLIT_GATE",
              "TRT_MIN_LEAF"):
        monkeypatch.delenv(k, raising=False)
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    v = MESHES["colonnade"]()
    got = mesh.MeshPrimitive.from_triangles(*v, **port_kw)
    want = JaxMesh.from_triangles(*v, builder=jax_builder,
                                  exact_normals=port_kw.get("exact_normals", True))
    assert_same_bvh(got.bvh, want.bvh)
    for f in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_presplit_default_rule_is_the_jax_packages():
    """The default presplit turns on exactly where the JAX package's
    does (``_paged_only_size``), checked at the threshold's count; and
    ``from_triangles`` applies it (at a lowered threshold: no 1.3M build)."""
    thr = mesh.PRESPLIT_ABOVE_TRIS
    for n in (82_000, 1_036_802, thr - 8, thr, thr + 1, thr + 8, 1_316_744, 2_000_000):
        assert (mesh.default_presplit(n) > 0) == _paged_only_size(n), n
    assert mesh.default_presplit(thr) == 0.0 and mesh.default_presplit(thr + 1) == 1.3


def test_from_triangles_applies_the_default_presplit(monkeypatch):
    v = MESHES["colonnade"]()
    monkeypatch.setattr(mesh, "PRESPLIT_ABOVE_TRIS", len(v[0]) - 1)
    got = mesh.MeshPrimitive.from_triangles(*v)
    want = build_bvh(*v, max_depth=mesh.MAX_DEPTH, min_leaf_size=mesh.MIN_LEAF_SIZE,
                     refs=presplit_refs(*v, budget_factor=1.3))
    assert_same_bvh(got.bvh, want)
    assert len(got.bvh.order) > len(v[0])
    monkeypatch.setattr(mesh, "PRESPLIT_ABOVE_TRIS", len(v[0]))
    assert len(mesh.MeshPrimitive.from_triangles(*v).bvh.order) == len(v[0])


def colonnade_scene(**build) -> "object":
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.6, 0.3)))
    scene.add_mesh(mesh.MeshPrimitive.from_triangles(*MESHES["colonnade"](), **build))
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene.compile("cpu")


TREES = {"plain": {}, "presplit": {"presplit": 0.3}, "optimized": {"opt_rounds": 2}}
_scenes = {}


def scene_and_rays(tree):
    if tree not in _scenes:
        cam = Camera.looking(64, 64, fov_deg=65.0, pose=[1.0, -1.5, 1.2, 0, 0, 0])
        p = cam.ray_params("cpu")
        o, d = generate_rays(64, 64, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        _scenes[tree] = (colonnade_scene(**TREES[tree]), o, d)
    return _scenes[tree]


def plain_cast(kernel, scene, o, d):
    if kernel == "K1":
        return traversal.cast_rays_wide_torch(scene, o, d)
    if kernel == "K2":
        return binary.cast_rays_binary_torch(scene, o, d)
    tables = scene.with_paging(page_tris=32, page_nodes=64, wide=kernel != "K5")
    if kernel == "K6":
        return paged_major.cast_rays_paged_major_torch(tables, o, d)
    return paged.cast_rays_paged_torch(tables, o, d)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5", "K6"])
@pytest.mark.parametrize("tree", ["presplit", "optimized"])
def test_plain_casts_on_new_trees_agree_with_brute_and_plain_tree(tree, kernel):
    scene, o, d = scene_and_rays(tree)
    plain_scene = scene_and_rays("plain")[0]
    if tree == "presplit":  # duplicated references: more leaf rows than triangles
        assert int(scene.node_leaf_count[scene.node_child_a < 0].sum()) > 1154
    hit = plain_cast(kernel, scene, o, d)
    brute = cast_rays_brute(scene, o, d)
    far = ~torch.isclose(hit.t, brute.t, rtol=BRUTE_RTOL, atol=BRUTE_RTOL)
    sub = lambda h: type(h)(*(x[far] for x in h[:3]))
    assert traversal.unexplained_differences(scene, o, d[far], sub(hit), sub(brute)) == 0
    assert (hit.tri >= 0).float().mean() > 0.5
    # against K1 on the plain tree: the triangle records are the same
    # rows, so t agrees but where box order decides (each such ray is
    # explained against the brute cast above)
    k1 = traversal.cast_rays_wide_torch(plain_scene, o, d)
    same_t = hit.t.view(torch.int32) == k1.t.view(torch.int32)
    assert float(same_t.float().mean()) > 0.999
