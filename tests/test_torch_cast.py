"""Nearest-hit casts of the port against the JAX package, and the CPU
build of kernel K1's own traversal code against its plain version.

Every comparison runs on the JAX package's own rays and scene (carried
over with ``from_scene_arrays``), so ray-generation drift cannot hide a
traversal fault.

Tolerances: against ``cast_rays_dual`` in interpret mode, t at rtol 1e-6
/ atol 1e-6 as tests/test_dual.py holds it (interpret mode contracts
FMAs, so it is not bit-exact even against the JAX package's own brute
cast). Against the JAX brute cast, which rounds every op separately
like the port, t is bit-exact. tri/inst are equal except at exact-t ties
(kernels/tlas.py:20-31), where both answers must have the same t.
The host build of K1 (g++ -ffp-contract=off) must equal the plain
version bit for bit.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from tpu_raytracer.kernels.dual import cast_rays_dual
from tpu_raytracer.render.renderer import cast_rays_brute as jax_brute
from tpu_raytracer_torch.core.vecmath import FLT_MAX
from tpu_raytracer_torch.kernels import build, traversal
from tpu_raytracer_torch.render.renderer import cast_rays_brute as port_brute
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_torch_scene import compiled, jax_fields, jax_rays

torch.set_num_threads(1)


def port_scene(name):
    return from_scene_arrays(jax_fields(compiled(name, "jax")[0]), device="cpu")


def port_rays(name):
    o, d = jax_rays(name)
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


def assert_same_hits(got, want, exact_t):
    t_g, t_w = np.asarray(got.t), np.asarray(want.t)
    if exact_t:
        np.testing.assert_array_equal(t_g.view(np.int32), t_w.view(np.int32))
    else:
        np.testing.assert_allclose(t_g, t_w, rtol=1e-6, atol=1e-6)
    tri_g, tri_w = np.asarray(got.tri), np.asarray(want.tri)
    differ = (tri_g != tri_w) | (np.asarray(got.inst) != np.asarray(want.inst))
    # a different triangle is only allowed at an exact-t tie: both hits
    # real, same distance
    assert (tri_g[differ] >= 0).all() and (tri_w[differ] >= 0).all()
    np.testing.assert_array_equal(t_g[differ], t_w[differ])


@pytest.mark.parametrize("name", ["cube", "blob4"])
def test_plain_walk_matches_jax_dual_kernel(name):
    ja, _ = compiled(name, "jax")
    o, d = jax_rays(name)
    want = cast_rays_dual(ja, o, d, interpret=True, wide=True)
    got = traversal.cast_rays_wide_torch(port_scene(name), *port_rays(name))
    assert_same_hits(got, want, exact_t=False)
    assert (np.asarray(got.tri) >= 0).mean() > 0.1


@pytest.mark.parametrize("name", ["cube", "two_instance", "blob4"])
def test_plain_walk_matches_jax_brute(name):
    ja, _ = compiled(name, "jax")
    want = jax_brute(ja, *jax_rays(name))
    got = traversal.cast_rays_wide_torch(port_scene(name), *port_rays(name))
    assert_same_hits(got, want, exact_t=True)
    if name == "two_instance":
        assert set(np.unique(np.asarray(got.inst)).tolist()) == {-1, 0, 1}


@pytest.mark.parametrize("name", ["cube", "two_instance"])
def test_port_brute_matches_jax_brute(name):
    ja, _ = compiled(name, "jax")
    want = jax_brute(ja, *jax_rays(name))
    got = port_brute(port_scene(name), *port_rays(name), tri_chunk=7)
    assert_same_hits(got, want, exact_t=True)


def test_plain_walk_chunks_and_per_ray_origins_agree():
    scene = port_scene("two_instance")
    o, d = port_rays("two_instance")
    whole = traversal.cast_rays_wide_torch(scene, o, d)
    per_ray = traversal.cast_rays_wide_torch(scene, o.expand(d.shape).contiguous(), d,
                                             chunk=1000)
    for a, b in zip(whole[:3], per_ray[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    scene = port_scene("cube")
    o, d = port_rays("cube")
    before = dict(build.LAUNCHES)
    got = traversal.cast_rays_cuda(scene, o, d)
    want = traversal.cast_rays_wide_torch(scene, o, d)
    assert build.LAUNCHES == before
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_router_raises_for_unported_routes():
    """Two or more instances with a TLAS route to K3, others to K1; a
    scene without wide tables raises for the paged kernels K4-K6."""
    from tpu_raytracer_torch.kernels import tlas

    scene = port_scene("two_instance")
    o, d = port_rays("two_instance")
    assert scene.tlas is not None and port_scene("cube").tlas is None
    for occlusion in (False, True):
        got = traversal.cast_rays(scene, o, d, occlusion=occlusion)
        want = tlas.cast_rays_tlas_torch(scene, o, d, occlusion=occlusion)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    no_tlas = dataclasses.replace(scene, tlas=None)
    got = traversal.cast_rays(no_tlas, o, d)
    for a, b in zip(got[:3], traversal.cast_rays_wide_torch(scene, o, d)[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    no_wide = dataclasses.replace(port_scene("cube"), wide4=None)
    with pytest.raises(NotImplementedError, match="K4"):
        traversal.cast_rays(no_wide, *port_rays("cube"))
    with pytest.raises(ValueError, match="origin"):
        traversal.cast_rays_cuda(port_scene("cube"), torch.zeros(2), port_rays("cube")[1])


def host_trace_spills(scene, origin, directions, occlusion=False, arity=4, short_stack=None,
                      t_max=traversal.BIG):
    """The traversal header of K1 (``arity`` 4, the node records
    ``wnode``) or K2 (2, the binary records), built for the host with
    ``short_stack`` ring slots (default ``wide4.SHORT_STACK``), over every
    ray, each walk bounded by ``t_max``: (t, tri, inst, entries the short
    stack spilled)."""
    lib = build.load("host", short_stack)
    tables = scene.wide4
    tree = scene.binary if arity == 2 else None
    root = tables.wroot if tree is None else tree.root
    node = tables.wnode if tree is None else tree.node
    inst_tab = traversal.instance_table(scene)
    inst_root = root[scene.inst_mesh.long()].to(torch.int32).contiguous()
    d = directions.contiguous()
    o = origin.contiguous()
    r = d.numel() // 3
    t = torch.empty(r, dtype=torch.float32)
    tri = torch.empty(r, dtype=torch.int32)
    inst = torch.empty(r, dtype=torch.int32)
    spills = ctypes.c_int64(-1)
    rc = lib.wt_trace_host(
        arity, node.data_ptr(), tables.tri_rec.data_ptr(), inst_tab.data_ptr(),
        inst_root.data_ptr(), ctypes.c_int(scene.num_instances), o.data_ptr(),
        0 if o.dim() == 1 else 3, d.data_ptr(), r, int(occlusion), t.data_ptr(),
        tri.data_ptr(), inst.data_ptr(), None, None, None, t_max, ctypes.byref(spills),
    )
    assert rc == 0
    return t, tri, inst, spills.value


def host_trace(scene, origin, directions, occlusion=False, arity=4, short_stack=None,
               t_max=traversal.BIG):
    """``host_trace_spills`` without the spill count."""
    return host_trace_spills(scene, origin, directions, occlusion, arity, short_stack,
                             t_max=t_max)[:3]


def assert_bitwise(t, tri, inst, want):
    np.testing.assert_array_equal(t.view(torch.int32).numpy(),
                                  want.t.reshape(-1).view(torch.int32).numpy())
    np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
    np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())


@pytest.mark.parametrize("name", ["cube", "two_instance", "blob3"])
def test_kernel_header_host_build_matches_plain_walk(name):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene = port_scene(name)
    o, d = port_rays(name)
    want = traversal.cast_rays_wide_torch(scene, o, d)
    t, tri, inst = host_trace(scene, o, d)
    assert_bitwise(t, tri, inst, want)


# a short stack of 1 ring slot spills on every scene whose walk ever
# holds 2 entries (all but the cube, whose 12 triangles fill one node)
TINY_STACK = 1


@pytest.mark.parametrize("name", ["cube", "two_instance", "blob3", "blob4"])
def test_host_build_with_tiny_short_stack_matches_plain_walk(name):
    """K1's walk with its short stack cut to 1 ring slot, so that entries
    go through the spill path, equals the plain walk bit for bit, nearest
    and any hit; the spill count shows the path was taken."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene = port_scene(name)
    o, d = port_rays(name)
    assert build.load("host", TINY_STACK).wt_host_short_stack() == TINY_STACK
    want = traversal.cast_rays_wide_torch(scene, o, d)
    t, tri, inst, spills = host_trace_spills(scene, o, d, short_stack=TINY_STACK)
    assert_bitwise(t, tri, inst, want)
    assert (spills > 0) == (name != "cube")
    occ = host_trace(scene, o, d, occlusion=True, short_stack=TINY_STACK)[0]
    want_occ = traversal.cast_rays_wide_torch(scene, o, d, occlusion=True)
    np.testing.assert_array_equal(occ.view(torch.int32).numpy(),
                                  want_occ.t.reshape(-1).view(torch.int32).numpy())


def test_wnode_unpacks_to_wcode_and_wbox():
    """Lane for lane, the node records hold wbox's 24 box floats (child
    c's coordinate k in lane 6c + k) and wcode's bits in lanes 24..27,
    bit for bit, and zeros after them; they follow the scene to another
    device."""
    for name in ("cube", "two_instance", "blob3"):
        w = port_scene(name).wide4
        n = w.wcode.shape[0]
        rec = w.wnode.numpy()
        assert rec.shape == (n, 32) and rec.dtype == np.float32
        np.testing.assert_array_equal(rec[:, :24].view(np.int32),
                                      w.wbox.numpy()[:, :24].view(np.int32))
        np.testing.assert_array_equal(rec[:, 24:28].view(np.int32), w.wcode.numpy())
        assert not rec[:, 28:].view(np.int32).any() and not w.wbox.numpy()[:, 24:].any()
        assert torch.equal(w.to("cpu").wnode.view(torch.int32), w.wnode.view(torch.int32))


BIG = float(np.float32(traversal.BIG))
SORT_CASES = [
    [1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0], [2.0, 2.0, 2.0, 2.0],
    [BIG, BIG, BIG, BIG], [BIG, 1.0, BIG, 0.5], [0.0, -0.0, 0.0, -0.0],
    [-0.0, 0.0, -1.0, 0.0], [3.0, 1.0, 3.0, 1.0], [1.0, BIG, 1.0, -2.0],
    [-5.0, -5.0, BIG, -5.0], [0.5, 0.25, 0.25, 0.5], [BIG, -0.0, 0.0, BIG],
]


def sort_order(dist: np.ndarray) -> np.ndarray:
    """The order walk.cuh's sorting network gives each row of ``dist``
    [n, A] (A = 2 or 4), from the host build: child of rank p in column p."""
    dist = np.ascontiguousarray(dist, np.float32)
    got = np.empty(dist.shape, np.int32)
    assert build.load("host").wt_sort_host(dist.shape[1], dist.ctypes.data, dist.shape[0],
                                           got.ctypes.data) == 0
    return got


def rank_loop_order(dist: np.ndarray) -> np.ndarray:
    """walk_tree's rank loop: child c's rank is the count of k with d[k] <
    d[c] or d[k] == d[c] and k < c; order[rank] = c."""
    dc, dk = dist[:, :, None], dist[:, None, :]
    lane = np.arange(dist.shape[1])
    rank = ((dk < dc) | ((dk == dc) & (lane[None, :] < lane[:, None]))).sum(-1)
    want = np.empty(dist.shape, np.int32)
    np.put_along_axis(want, rank, np.broadcast_to(lane, rank.shape), axis=1)
    return want


def test_sorting_network_matches_rank_loop():
    """walk.cuh's 4-input sorting network orders children as walk_tree's
    rank loop (near first, ties by child index) on hand-made distances
    with ties, signed zeros and BIG, and on every permutation-rich random
    vector."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    rng = np.random.default_rng(3)
    pool = np.array([-1.0, -0.0, 0.0, 0.5, 1.0, BIG], np.float32)
    dist = np.concatenate([np.array(SORT_CASES, np.float32),
                           pool[rng.integers(0, pool.size, (4096, 4))]])
    np.testing.assert_array_equal(sort_order(dist), rank_loop_order(dist))


def test_binary_sort_matches_rank_loop():
    """At arity 2 the walk's one compare-exchange gives the rank loop's
    order: every pair of the pool's values, ties and signed zeros
    included, and the hand-made 4-child cases cut to their first two."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    pool = np.array([-1.0, -0.0, 0.0, 0.5, 1.0, BIG], np.float32)
    pairs = np.stack(np.meshgrid(pool, pool), -1).reshape(-1, 2)
    dist = np.concatenate([pairs, np.array(SORT_CASES, np.float32)[:, :2]])
    got = sort_order(dist)
    np.testing.assert_array_equal(got, rank_loop_order(dist))
    assert (got[:, 0] == 1).any() and (got[:, 0] == 0).any()


# AO's radius in the benchmark's AO cell (rtbench/traffic/ao_1080p.json)
AO_RADIUS = 1.0


def tiny_colonnade(width=48, height=32):
    """(scene, origin, directions) of the benchmark's ``tiny`` colonnade
    (rtbench/configs/colonnade.json: ``procgen.colonnade(4, 4, 8, 4)``,
    1,026 triangles) on the CPU, with the primary rays of
    ``scene_colonnade``'s camera."""
    from tpu_raytracer_torch.render import Camera, generate_rays
    from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

    sc = Scene()
    sc.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    sc.add_mesh(MeshPrimitive.from_triangles(*procgen.colonnade(4, 4, 8, 4)))
    sc.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(width, height, fov_deg=65.0, pose=[1.0, -2.0, 1.6, 0, 0, 0])
    p = cam.ray_params("cpu")
    return sc.compile("cpu"), *generate_rays(width, height, p["K_inv"], p["D"], p["pose"],
                                             p["inv_pose"])


def ao_sample_rays():
    """(scene, origins, directions, live) of AO's first sample rays on
    ``tiny_colonnade``, cast from the primary hits as ``render_ao`` casts
    them, rays off missed pixels parked; ``live`` [R] marks the rays that
    are not parked."""
    from tpu_raytracer_torch.render import hit_attributes
    from tpu_raytracer_torch.render.integrators import sample_cosine
    from tpu_raytracer_torch.render.shade import SHADOW_EPS
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
    from tpu_raytracer_torch.utils import prng

    scene, o, d = tiny_colonnade()
    attrs = hit_attributes(scene, o, d, traversal.cast_rays(scene, o, d))
    nd = sample_cosine(prng.PRNGKey(2147500301), (0,), attrs.normal)
    ro, rd = park_dead_rays(attrs.location + nd * SHADOW_EPS, nd, attrs.hit)
    return scene, ro, rd, attrs.hit.reshape(-1)


def plain_cast(arity):
    from tpu_raytracer_torch.kernels import binary

    return traversal.cast_rays_wide_torch if arity == 4 else binary.cast_rays_binary_torch


@pytest.mark.parametrize("t_max", [AO_RADIUS, traversal.BIG])
@pytest.mark.parametrize("arity", [4, 2])
def test_bounded_host_walk_matches_plain_walk_on_ao_rays(arity, t_max):
    """K1's (``arity`` 4) and K2's (2) walks bounded by AO's radius, or
    unbounded at BIG (the plain walks' default, held to the JAX package's
    casts above), equal their plain versions bit for bit on AO's sample
    rays, nearest hit (t, tri, inst) and any hit; the rays hold hits,
    misses and parked rays, and hits beyond the radius, which the bound
    turns into misses."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene, o, d, live = ao_sample_rays()
    cast = plain_cast(arity)
    want = cast(scene, o, d, t_max=t_max)
    t, tri, inst = host_trace(scene, o, d, arity=arity, t_max=t_max)
    assert_bitwise(t, tri, inst, want)
    occ = host_trace(scene, o, d, occlusion=True, arity=arity, t_max=t_max)[0]
    want_occ = cast(scene, o, d, occlusion=True, t_max=t_max)
    assert torch.equal(occ.view(torch.int32), want_occ.t.reshape(-1).view(torch.int32))
    assert (live & (tri >= 0)).any() and (live & (tri < 0)).any()
    assert (~live).any() and (tri[~live] < 0).all()
    far = cast(scene, o, d).t.reshape(-1)
    assert ((far >= AO_RADIUS) & (far < FLT_MAX)).any()


@pytest.mark.parametrize("arity", [4, 2])
def test_bounded_walk_keeps_the_hits_within_the_bound_and_pops_less(arity):
    """The bounded plain walk reports exactly the unbounded walk's hits
    nearer than the bound (t, tri, inst), misses elsewhere, and pops no
    more nodes and tests no more triangles than the unbounded walk, summed
    over AO's sample rays (fewer on these rays)."""
    scene, o, d, _ = ao_sample_rays()
    cast = plain_cast(arity)
    near, far_stats = cast(scene, o, d, stats=True)
    got, stats = cast(scene, o, d, stats=True, t_max=AO_RADIUS)
    within = near.t < AO_RADIUS
    assert within.any() and (~within & (near.t < FLT_MAX)).any()
    assert torch.equal(got.t[within].view(torch.int32), near.t[within].view(torch.int32))
    assert torch.equal(got.tri[within], near.tri[within])
    assert torch.equal(got.inst[within], near.inst[within])
    assert (got.t[~within] == FLT_MAX).all() and (got.tri[~within] == -1).all()
    for k in ("pops", "tests"):
        assert int(stats[k].sum()) < int(far_stats[k].sum()), k
