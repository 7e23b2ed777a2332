"""Kernel K3 (the two-level TLAS cast) of the port: its tables and plain
version against the JAX package, the CPU build of its traversal header
against the plain version, and the any-hit mode of K1 and K3.

Scenes are the JAX package's own (``tpu_raytracer/app/scenes.py``),
carried over with ``from_scene_arrays``, and rays are the JAX package's
primary rays, so only the cast is compared.

Tolerances. Against the JAX brute cast, which rounds every op
separately like the port, ``t`` is bit-exact; ``tri``/``inst`` are
equal except at exact-``t`` ties, where both answers must have the same
``t``. Against ``cast_rays_tlas`` in interpret mode, ``t`` at rtol/atol
1e-6 (interpret mode contracts FMAs). The host build of K3
(g++ -ffp-contract=off) equals the plain version bit for bit in all
three outputs, and the plain version equals K1's linear instance loop
bit for bit, since the lower instance wins an exact-``t`` tie in both.
TLAS boxes are within 2 ulps of the JAX build's: the world corners go
through each package's own sin/cos, which may differ by an ulp.
"""

import ctypes
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
from tpu_raytracer.kernels.tlas import cast_rays_tlas as jax_tlas
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.renderer import cast_rays_brute as jax_brute
from tpu_raytracer.scene import MeshInstance as JaxMeshInstance
from tpu_raytracer_torch.core.vecmath import FLT_MAX, normalize
from tpu_raytracer_torch.kernels import build, tlas, traversal
from tpu_raytracer_torch.render.integrators import _reflect
from tpu_raytracer_torch.render.renderer import cast_rays_brute as port_brute
from tpu_raytracer_torch.render.renderer import hit_attributes
from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION, SHADOW_EPS
from tpu_raytracer_torch.render.sorted_cast import PARK_ORIGIN, park_dead_rays
from tpu_raytracer_torch.scene import MeshInstance
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_torch_cast import assert_same_hits, port_scene
from test_torch_scene import jax_fields

torch.set_num_threads(1)

# CPU-sized cuts of BASELINE config 4, the 16-instance TLAS scene and
# config 2 (the Cornell box: 6 instances)
JAX_SCENES = {
    "instances": lambda: jscenes.scene_instances(32, 32),
    "instances16": lambda: jscenes.scene_instances16(48, 32),
    "cornell": lambda: jscenes.scene_cornell(32),
}


@functools.lru_cache(maxsize=None)
def jax_scene(name):
    return JAX_SCENES[name]()


@functools.lru_cache(maxsize=None)
def scene_and_rays(name):
    """(port scene, origin [3], directions [H, W, 3]) on the JAX
    package's scene and primary rays."""
    ja, cam = jax_scene(name)
    p = cam.ray_params()
    o, d = jax_generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"],
                             p["inv_pose"])
    return (from_scene_arrays(jax_fields(ja), device="cpu"), torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(d)))


def reflection_rays(scene, o, d):
    """First-bounce mirror rays from the primary hits, dead rays parked:
    per-ray origins, incoherent directions."""
    hit = tlas.cast_rays_tlas_torch(scene, o, d)
    attrs = hit_attributes(scene, o, d, hit)
    rd = normalize(_reflect(d, attrs.normal))
    return park_dead_rays(attrs.location + rd * SHADOW_EPS, rd, attrs.hit)


def shadow_rays(scene, o, d, cast):
    """Rays from the primary hits toward the default light."""
    attrs = hit_attributes(scene, o, d, cast(scene, o, d))
    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32))
    return park_dead_rays(attrs.location + ldir * SHADOW_EPS,
                          ldir.expand(attrs.location.shape), attrs.hit)


def ray_sets(name):
    scene, o, d = scene_and_rays(name)
    return scene, {"primary": (o, d), "reflection": reflection_rays(scene, o, d)}


def bits(t):
    return t.reshape(-1).view(torch.int32)


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_tlas_tables_match_jax(name):
    ja, _ = jax_scene(name)
    got = scene_and_rays(name)[0].tlas
    n = got.code.shape[0]
    np.testing.assert_array_equal(got.code.numpy(), np.asarray(ja.tlas.code))
    np.testing.assert_array_equal(got.inst_ids.numpy(), np.asarray(ja.tlas.inst_ids))
    want_box = np.asarray(ja.tlas.nodef).reshape(-1, 16)[:n, :12]
    ulps = np.abs(got.box.numpy().view(np.int32).astype(np.int64)
                  - want_box.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert got.depth < tlas.TLAS_STACK


@pytest.mark.parametrize("name", ["instances", "cornell"])
def test_plain_version_matches_jax_brute(name):
    ja, _ = jax_scene(name)
    scene, o, d = scene_and_rays(name)
    want = jax_brute(ja, o.numpy(), d.numpy())
    got = tlas.cast_rays_tlas_torch(scene, o, d)
    assert_same_hits(got, want, exact_t=True)
    inst = got.inst.numpy()
    assert len(np.unique(inst[inst >= 0])) >= 3


def test_plain_version_matches_jax_tlas_kernel():
    ja, _ = jax_scene("instances")
    scene, o, d = scene_and_rays("instances")
    want = jax_tlas(ja, o.numpy(), d.numpy(), interpret=True)
    got = tlas.cast_rays_tlas_torch(scene, o, d)
    assert_same_hits(got, want, exact_t=False)


@pytest.mark.parametrize("rays", ["primary", "reflection"])
@pytest.mark.parametrize("name", ["instances", "instances16"])
def test_plain_version_matches_linear_instance_loop(name, rays):
    """The TLAS only prunes: K3's plain version equals K1's (every
    instance in index order) in all three outputs, so its boxes are
    conservative and its tie rule is the linear loop's."""
    scene, sets = ray_sets(name)
    o, d = sets[rays]
    got = tlas.cast_rays_tlas_torch(scene, o, d)
    want = traversal.cast_rays_wide_torch(scene, o, d)
    assert (got.tri >= 0).any()
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def host_trace_spills(scene, origin, directions, occlusion=False, short_stack=None):
    """K3's traversal header, built for the host with ``short_stack``
    ring slots (default ``wide4.SHORT_STACK``), over every ray: (t, tri,
    inst, entries spilled)."""
    lib = build.load("host", short_stack)
    tables, tl = scene.wide4, scene.tlas
    inst_tab = traversal.instance_table(scene)
    inst_root = tables.wroot[scene.inst_mesh.long()].to(torch.int32).contiguous()
    d = directions.contiguous()
    o = origin.contiguous()
    r = d.numel() // 3
    t = torch.empty(r, dtype=torch.float32)
    tri = torch.empty(r, dtype=torch.int32)
    inst = torch.empty(r, dtype=torch.int32)
    spills = ctypes.c_int64(-1)
    rc = lib.tlas_trace_host(
        tables.wnode.data_ptr(), tables.tri_rec.data_ptr(), inst_tab.data_ptr(),
        inst_root.data_ptr(), scene.num_instances,
        tl.code.data_ptr(), tl.box.data_ptr(), tl.inst_ids.data_ptr(),
        o.data_ptr(), 0 if o.dim() == 1 else 3, d.data_ptr(), r, int(occlusion),
        t.data_ptr(), tri.data_ptr(), inst.data_ptr(), None, None, None, ctypes.byref(spills),
    )
    assert rc == 0
    return t, tri, inst, spills.value


def host_trace(scene, origin, directions, occlusion=False, short_stack=None):
    """``host_trace_spills`` without the spill count."""
    return host_trace_spills(scene, origin, directions, occlusion, short_stack)[:3]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_kernel_header_host_build_matches_plain_version(gxx, name):
    scene, sets = ray_sets(name)
    for o, d in sets.values():
        want = tlas.cast_rays_tlas_torch(scene, o, d)
        t, tri, inst = host_trace(scene, o, d)
        np.testing.assert_array_equal(bits(t).numpy(), bits(want.t).numpy())
        np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
        np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())
        occ_t, _, _ = host_trace(scene, o, d, occlusion=True)
        want_occ = tlas.cast_rays_tlas_torch(scene, o, d, occlusion=True)
        np.testing.assert_array_equal(bits(occ_t).numpy(), bits(want_occ.t).numpy())


@pytest.mark.parametrize("kernel,name", [("K1", "blob3"), ("K1", "instances"),
                                         ("K3", "instances")])
def test_any_hit_agrees_with_nearest_hit(gxx, kernel, name):
    """Shadow rays from the primary hits toward the light: the any-hit
    answer (t = -BIG blocked, FLT_MAX clear) of the host build and of the
    plain version equals the nearest-hit cast's blocked/clear answer on
    every ray. (K1 walks every instance in turn, so it takes config 4
    too; on the convex blob almost no ray is blocked.)"""
    from test_torch_cast import host_trace as k1_host_trace
    from test_torch_cast import port_rays

    if name == "blob3":
        scene, (o, d) = port_scene(name), port_rays(name)
    else:
        scene, o, d = scene_and_rays(name)
    if kernel == "K1":
        cast, trace = traversal.cast_rays_wide_torch, k1_host_trace
    else:
        cast, trace = tlas.cast_rays_tlas_torch, host_trace
    so, sd = shadow_rays(scene, o, d, cast)
    nearest = cast(scene, so, sd)
    blocked = (nearest.t < FLT_MAX).reshape(-1)
    assert blocked.any() and not blocked.all()
    for t in (trace(scene, so, sd, occlusion=True)[0], cast(scene, so, sd, occlusion=True).t):
        t = t.reshape(-1)
        assert set(torch.unique(t).tolist()) <= {float(np.float32(-traversal.BIG)), FLT_MAX}
        np.testing.assert_array_equal((t < 0).numpy(), blocked.numpy())


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_host_build_with_tiny_short_stack_matches_plain_version(gxx, name):
    """K3's walk with its one stack (TLAS entries below, BLAS above) cut
    to 1 ring slot, so that entries go through the spill path on every
    scene, equals the plain version bit for bit on primary and reflection
    rays, nearest and any hit."""
    from test_torch_cast import TINY_STACK

    scene, sets = ray_sets(name)
    for o, d in sets.values():
        want = tlas.cast_rays_tlas_torch(scene, o, d)
        t, tri, inst, spills = host_trace_spills(scene, o, d, short_stack=TINY_STACK)
        assert spills > 0
        np.testing.assert_array_equal(bits(t).numpy(), bits(want.t).numpy())
        np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
        np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())
        occ_t = host_trace(scene, o, d, occlusion=True, short_stack=TINY_STACK)[0]
        want_occ = tlas.cast_rays_tlas_torch(scene, o, d, occlusion=True)
        np.testing.assert_array_equal(bits(occ_t).numpy(), bits(want_occ.t).numpy())


@pytest.mark.parametrize("kernel,name", [("K1", "blob3"), ("K1", "instances"),
                                         ("K3", "instances"), ("K3", "cornell")])
def test_unordered_any_hit_with_tiny_short_stack(gxx, kernel, name):
    """The any-hit walk, which takes children in child order, with 1 ring
    slot: its blocked/clear answer on shadow rays equals the nearest-hit
    cast's on every ray."""
    from test_torch_cast import TINY_STACK, port_rays
    from test_torch_cast import host_trace as k1_host_trace

    if name == "blob3":
        scene, (o, d) = port_scene(name), port_rays(name)
    else:
        scene, o, d = scene_and_rays(name)
    cast, trace = ((traversal.cast_rays_wide_torch, k1_host_trace) if kernel == "K1"
                   else (tlas.cast_rays_tlas_torch, host_trace))
    so, sd = shadow_rays(scene, o, d, cast)
    blocked = (cast(scene, so, sd).t < FLT_MAX).reshape(-1)
    assert blocked.any() and not blocked.all()
    t = trace(scene, so, sd, occlusion=True, short_stack=TINY_STACK)[0].reshape(-1)
    assert set(torch.unique(t).tolist()) <= {float(np.float32(-traversal.BIG)), FLT_MAX}
    np.testing.assert_array_equal((t < 0).numpy(), blocked.numpy())


def test_parked_rays_miss_without_inf_or_nan(gxx):
    scene, o, d = scene_and_rays("instances16")
    po, pd = park_dead_rays(o.expand(d.shape), d, torch.zeros(d.shape[:-1], dtype=torch.bool))
    assert (po == PARK_ORIGIN).all()
    for occlusion in (False, True):
        plain = tlas.cast_rays_tlas_torch(scene, po, pd, occlusion=occlusion)
        t, tri, _ = host_trace(scene, po, pd, occlusion)
        for tt in (plain.t, t):
            assert (tt == FLT_MAX).all()
        assert (plain.tri == -1).all() and (tri == -1).all()


def test_update_instance_rebuilds_tlas_like_jax():
    ja, _ = jax_scene("instances")
    scene, o, d = scene_and_rays("instances")
    pose = np.array([0.2, 2.2, -0.4, 1.0, 0.3, 0.0], np.float32)
    scale = np.array([0.6, 0.9, 0.7], np.float32)
    jm = JaxMeshInstance(1, 2)
    jm.pose, jm.scale = pose, scale
    pm = MeshInstance(1, 2, pose=pose, scale=scale)
    jup = ja.update_instance(2, jm)
    up = scene.update_instance(2, pm)
    assert scene.tlas is not None and up.wide4 is scene.wide4
    np.testing.assert_array_equal(up.tlas.code.numpy(), np.asarray(jup.tlas.code))
    np.testing.assert_array_equal(up.tlas.inst_ids.numpy(), np.asarray(jup.tlas.inst_ids))
    n = up.tlas.code.shape[0]
    want_box = np.asarray(jup.tlas.nodef).reshape(-1, 16)[:n, :12]
    np.testing.assert_allclose(up.tlas.box.numpy(), want_box, rtol=1e-6, atol=1e-6)
    # the cast follows the new pose: it equals the brute cast on the
    # updated scene and differs from the cast before the update
    before = tlas.cast_rays_tlas_torch(scene, o, d)
    after = tlas.cast_rays_tlas_torch(up, o, d)
    assert (before.inst != after.inst).any()
    assert_same_hits(after, port_brute(up, o, d), exact_t=True)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    scene, o, d = scene_and_rays("cornell")
    before = dict(build.LAUNCHES)
    got = tlas.cast_rays_tlas_cuda(scene, o, d, occlusion=True)
    want = tlas.cast_rays_tlas_torch(scene, o, d, occlusion=True)
    assert build.LAUNCHES == before
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    moved = scene.to("cpu")
    assert moved.tlas.depth == scene.tlas.depth
    with pytest.raises(ValueError, match="TLAS"):
        tlas.cast_rays_tlas_torch(dataclasses.replace(scene, tlas=None), o, d)
