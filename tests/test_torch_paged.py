"""The paged kernels K4, K5 and K6 of the port: their tables and plain
versions against the JAX package's paged casts, against K1's walk of the
same scene, the CPU build of their traversal header against the plain
versions, and the paged render backends.

Scenes are the JAX package's own test scenes, carried over with
``from_scene_arrays``: ``_two_instance_scene`` (a cube and an icosphere,
posed and scaled) and a small colonnade (``columns=4, segs=8``: 13,320
triangles), at 64x64 with the JAX package's primary rays. Pages are cut
as ``tests/test_paged*.py`` cut them (``page_tris=32, page_nodes=64``:
hundreds of one- or two-leaf pages) and, for page trees several levels
deep, at ``page_tris=512, page_nodes=256``.

Tolerances. Against the JAX paged casts in interpret mode ``t`` within
``JAX_T_ULPS`` ulps: interpret mode contracts FMAs, which moves ``t`` by
up to 4 ulps on ~5% of the colonnade's rays (the JAX package's own wide
kernel differs from its brute cast on the same rays) and by up to 14
ulps on one ray of the two-instance scene.
One colonnade ray hits the floor's edge within EDGE_EPS, outside the
floor's flat leaf box: the JAX kernels accept it, and the port's walks,
K1's included, cull that box and miss it. ``tri``/``inst`` are equal
except at near-ties, where both hit with ``t`` within those ulps, on
under 1% of the rays: with FMAs the JAX kernels can split an exact tie
at a shared edge by an ulp and take the other triangle. Against K1's
plain walk, which rounds every op as the paged walks do, ``t`` is
bit-exact and ``tri``/``inst`` equal away from exact-``t`` ties, since
a paged walk differs from K1's only in the order it visits triangles.
The host build of the kernels' header (g++ -ffp-contract=off) equals the
plain versions bit for bit in all three outputs, K4-K6 also with their
short stack cut to one slot, and so do K4 and K6 against themselves
through ``paged_from_jax`` tables. The host build of K6's plan
(``csrc/page_plan.cuh``) equals the plain plan bit for bit in item order
and per-tile lists.
"""

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
from tpu_raytracer.kernels.paged import cast_rays_paged as jax_paged
from tpu_raytracer.kernels.paged import prepare_paged as jax_prepare_paged
from tpu_raytracer.kernels.paged_major import cast_rays_paged_major as jax_paged_major
from tpu_raytracer.kernels.paged_wide import cast_rays_paged_wide as jax_paged_wide
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer_torch.core.vecmath import FLT_MAX, normalize
from tpu_raytracer_torch.kernels import build, paged, paged_major, traversal
from tpu_raytracer_torch.render import (
    RenderConfig, generate_rays, render_image, render_image_paged,
)
from tpu_raytracer_torch.render.integrators import _reflect
from tpu_raytracer_torch.render.renderer import hit_attributes
from tpu_raytracer_torch.render.shade import SHADOW_EPS
from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_pallas_interpret import _two_instance_scene
from test_torch_cast import assert_same_hits
from test_torch_scene import jax_fields

torch.set_num_threads(1)

JAX_SCENES = {
    "two_instance": _two_instance_scene,
    "colonnade": lambda: jscenes.scene_colonnade(64, 64, columns=4, segs=8),
}
# (page_tris, page_nodes): the JAX tests' tiny cut, and pages whose trees
# are several levels deep
CUTS = {"tiny": (32, 64), "deep": (512, 256)}
KERNELS = {"K4": True, "K5": False, "K6": True}  # kernel -> 4-wide tables
# t against the JAX paged casts in interpret mode (FMA-contracted): at
# most 14 ulps apart on these scenes
JAX_T_ULPS = 16


@functools.lru_cache(maxsize=None)
def jax_scene(name):
    arrays, cam = JAX_SCENES[name]()
    p = cam.ray_params()
    o, d = jax_generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"],
                             p["inv_pose"])
    return arrays, cam, np.array(o), np.array(d)


@functools.lru_cache(maxsize=None)
def port_scene(name, cut="tiny", wide=True):
    """(port scene with page tables, origin, directions) on the JAX
    package's scene and primary rays."""
    arrays, _, o, d = jax_scene(name)
    scene = from_scene_arrays(jax_fields(arrays), device="cpu")
    page_tris, page_nodes = CUTS[cut]
    return (scene.with_paging(page_tris=page_tris, page_nodes=page_nodes, wide=wide),
            torch.from_numpy(o), torch.from_numpy(d))


@functools.lru_cache(maxsize=None)
def jax_tables(name, wide):
    arrays = jax_scene(name)[0]
    return jax_prepare_paged(arrays, page_tris=32, page_nodes=64, wide=wide)


def jax_table_fields(tables) -> dict:
    names = ("top_root", "page_tab", "top_code", "top_nodef", "gcode", "gnodef", "pwcode",
             "pwnodef")
    return {k: np.asarray(getattr(tables, k)) for k in names if getattr(tables, k) is not None}


@functools.lru_cache(maxsize=None)
def jax_cast(name, kernel):
    arrays, _, o, d = jax_scene(name)
    tables = jax_tables(name, KERNELS[kernel])
    cast = {"K4": jax_paged_wide, "K5": jax_paged, "K6": jax_paged_major}[kernel]
    return cast(arrays, tables, o, d, interpret=True)


PLAIN = {"K4": paged.cast_rays_paged_torch, "K5": paged.cast_rays_paged_torch,
         "K6": paged_major.cast_rays_paged_major_torch}


def reflection_rays(scene, o, d):
    """First-bounce mirror rays from the primary hits, dead rays parked:
    per-ray origins, incoherent directions."""
    hit = traversal.cast_rays_wide_torch(scene, o, d)
    attrs = hit_attributes(scene, o, d, hit)
    rd = normalize(_reflect(d, attrs.normal))
    return park_dead_rays(attrs.location + rd * SHADOW_EPS, rd, attrs.hit)


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "binary"])
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_page_tables_match_jax(name, wide):
    """The port's page table, top tree and page trees equal the JAX
    ``prepare_paged`` content, unpacked from its 128-lane rows."""
    got = port_scene(name, "tiny", wide)[0].paged
    want = paged.paged_from_jax(jax_table_fields(jax_tables(name, wide)), device="cpu",
                                wide=wide)
    assert got.num_pages > 2 and got.arity == (4 if wide else 2)
    for field in ("top_code", "top_box", "top_root", "page_node0", "page_tri0", "node_base",
                  "code"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      getattr(want, field).numpy(), err_msg=field)
    # a page that is a whole single-leaf mesh (the cube) has no box in the
    # JAX binary tables: paged_from_jax gives it an unbounded one
    unbounded = want.box[:, 0].numpy() == np.float32(-3.0e38)
    assert unbounded.sum() == (name == "two_instance" and not wide)
    np.testing.assert_array_equal(got.box.numpy()[~unbounded], want.box.numpy()[~unbounded])
    assert (got.depth, got.top_depth) == (want.depth, want.top_depth)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_plain_version_matches_jax_paged_cast(name, kernel):
    scene, o, d = port_scene(name, "tiny", KERNELS[kernel])
    got = PLAIN[kernel](scene, o, d)
    want = jax_cast(name, kernel)
    t_g, t_w = got.t.numpy(), np.asarray(want.t)
    side = (t_g < FLT_MAX) == (t_w < FLT_MAX)
    assert (~side).sum() <= (name == "colonnade")
    k1 = traversal.cast_rays_wide_torch(scene, o, d)
    np.testing.assert_array_equal(t_g[~side], k1.t.numpy()[~side])
    ulps = np.abs(t_g.view(np.int32).astype(np.int64)
                  - np.asarray(t_w, np.float32).view(np.int32).astype(np.int64))
    assert ulps[side].max() <= JAX_T_ULPS
    tri_g, tri_w = got.tri.numpy(), np.asarray(want.tri)
    differ = side & ((tri_g != tri_w) | (got.inst.numpy() != np.asarray(want.inst)))
    # a different triangle only at a near-tie: both hit, t within the
    # ulps (asserted above)
    assert (tri_g[differ] >= 0).all() and (tri_w[differ] >= 0).all()
    assert differ.mean() < 0.01
    assert (got.tri >= 0).float().mean() > 0.1


@pytest.mark.parametrize("rays", ["primary", "reflection"])
@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_plain_version_matches_k1_walk(name, kernel, cut, rays):
    """Paging only changes the visit order: t equals K1's on the same
    scene bit for bit, tri/inst away from exact-t ties."""
    scene, o, d = port_scene(name, cut, KERNELS[kernel])
    if rays == "reflection":
        o, d = reflection_rays(scene, o, d)
    got = PLAIN[kernel](scene, o, d)
    assert_same_hits(got, traversal.cast_rays_wide_torch(scene, o, d), exact_t=True)
    if name == "two_instance" and rays == "primary":
        assert set(np.unique(got.inst.numpy()).tolist()) == {-1, 0, 1}


def host_plan(scene, origin, directions, lib=None):
    """K6's plan from the host build of ``csrc/page_plan.cuh`` for rays in
    tile order: (item_pid, item_iid, tile_start, tile_item), every item
    ordered, ``tile_item`` cut to its ``tile_start[-1]`` entries."""
    lib = lib or build.load("host")
    args, plan, keep_alive = paged_major.plan_args(scene, origin, directions)
    assert lib.page_plan_host(*args) == 0
    pid, iid, start, items = plan
    return pid, iid, start, items[:int(start[-1])]


def host_trace_paged(scene, origin, directions, kernel, short_stack=None, card_plan=False):
    """The paged kernels' traversal header, built for the host with
    ``short_stack`` ring slots (default ``wide4.SHORT_STACK``), over every
    ray (K6 on the tile order and the plain plan, or with ``card_plan`` the
    host build of the card's plan): (t, tri, inst, entries the short stack
    spilled)."""
    lib = build.load("host", short_stack)
    pg = scene.paged
    if kernel == "K6":
        perm, o, d = paged_major._tile_rays(origin, directions)
    else:
        perm, o, d = None, origin.contiguous(), directions.reshape(-1, 3).contiguous()
    pages, keep_alive = paged.page_args(scene, d)
    r = d.shape[0]
    out = (torch.empty(r), torch.empty(r, dtype=torch.int32), torch.empty(r, dtype=torch.int32))
    spills = ctypes.c_int64(0)
    if kernel == "K6":
        plan = (host_plan(scene, o, d, lib) if card_plan
                else paged_major.page_major_plan_cuda(scene, o, d))
        rc = lib.paged_major_trace_host(*pages, *(x.data_ptr() for x in plan),
                                        plan[2].shape[0] - 1, *paged.ray_args(o, d, out),
                                        ctypes.byref(spills))
    else:
        top_root = pg.top_root[scene.inst_mesh.long()].to(torch.int32).contiguous()
        rc = lib.paged_trace_host(*pages, pg.top_code.data_ptr(), pg.top_box.data_ptr(),
                                  top_root.data_ptr(), *paged.ray_args(o, d, out),
                                  ctypes.byref(spills))
    assert rc == 0
    return (*(paged_major._untile(perm, x) for x in out), spills.value)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_kernel_header_host_build_matches_plain_version(gxx, name, kernel, cut):
    scene, o, d = port_scene(name, cut, KERNELS[kernel])
    for ro, rd in ((o, d), reflection_rays(scene, o, d)):
        want = PLAIN[kernel](scene, ro, rd)
        got = host_trace_paged(scene, ro, rd, kernel)
        np.testing.assert_array_equal(got[0].view(torch.int32).numpy(),
                                      want.t.reshape(-1).view(torch.int32).numpy())
        np.testing.assert_array_equal(got[1].numpy(), want.tri.reshape(-1).numpy())
        np.testing.assert_array_equal(got[2].numpy(), want.inst.reshape(-1).numpy())


def assert_hits_equal(got, want):
    """Host build outputs (t, tri, inst[, spills]) against a plain Hit,
    bit for bit."""
    for g, w in zip(got[:3], (want.t.view(torch.int32), want.tri, want.inst)):
        np.testing.assert_array_equal(g.view(w.dtype).numpy(), w.reshape(-1).numpy())


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_k4_host_build_with_tiny_short_stack_matches_plain_version(gxx, name, cut):
    """K4 with its short stack cut to 1 ring slot, so that top-tree and
    page entries go through the spill path, equals the plain version bit
    for bit on primary and reflection rays; the spill count shows the
    path was taken."""
    scene, o, d = port_scene(name, cut, True)
    assert build.load("host", 1).wt_host_short_stack() == 1
    for ro, rd in ((o, d), reflection_rays(scene, o, d)):
        got = host_trace_paged(scene, ro, rd, "K4", short_stack=1)
        assert_hits_equal(got, paged.cast_rays_paged_torch(scene, ro, rd))
        assert got[3] > 0
        assert host_trace_paged(scene, ro, rd, "K4")[3] < got[3]


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_paged_host_build_with_tiny_short_stack_matches_plain_version(gxx, kernel, name, cut):
    """K5 and K6 as K4 above: with the short stack cut to 1 ring slot,
    bitwise equal to their plain versions on primary and reflection rays,
    the spill count showing that the spill path was taken (K6 also on
    the host build of the card's plan). K6 walks no top tree, so the
    tiny cut's one- and two-leaf pages never hold two entries: its
    spills are asserted on the deep cut."""
    scene, o, d = port_scene(name, cut, KERNELS[kernel])
    for ro, rd in ((o, d), reflection_rays(scene, o, d)):
        want = PLAIN[kernel](scene, ro, rd)
        got = host_trace_paged(scene, ro, rd, kernel, short_stack=1)
        assert_hits_equal(got, want)
        if kernel == "K5" or cut == "deep":
            assert got[3] > 0
            assert host_trace_paged(scene, ro, rd, kernel)[3] < got[3]
        if kernel == "K6":
            assert_hits_equal(host_trace_paged(scene, ro, rd, kernel, short_stack=1,
                                               card_plan=True), want)


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_plan_host_build_equals_plain_plan(gxx, name, cut):
    """The host build of K6's plan (``csrc/page_plan.cuh``) equals the
    plain ``page_major_plan`` bit for bit: the seen items in the same
    order, the unseen ones after them, and every tile's list, on primary
    rays (one origin, an image in 16x16-pixel tiles) and on reflection
    rays (per-ray origins, a last tile of pad rays)."""
    scene, o, d = port_scene(name, cut, True)
    ro, rd = reflection_rays(scene, o, d)
    sets = [paged_major._tile_rays(o, d)[1:],
            (ro.reshape(-1, 3)[:-37].contiguous(), rd.reshape(-1, 3)[:-37].contiguous())]
    for so, sd in sets:
        pid, iid, mask = paged_major.page_major_plan(scene, so, sd)
        start, items = paged_major.tile_lists(mask)
        h_pid, h_iid, h_start, h_items = host_plan(scene, so, sd)
        n = pid.shape[0]
        assert 0 < n and h_pid.shape[0] == scene.num_instances * scene.paged.num_pages
        assert torch.equal(h_pid[:n], pid) and torch.equal(h_iid[:n], iid)
        assert torch.equal(h_start, start) and torch.equal(h_items, items)
        # every item is ordered once; the unseen ones are in no list
        k = h_iid.long() * scene.paged.num_pages + h_pid.long()
        assert torch.equal(k.sort().values, torch.arange(k.shape[0]))
        assert items.numel() == 0 or int(items.max()) < n
        assert start[-1] > 0


def test_wide_page_records_unpack_to_code_and_box():
    """K4's and K6's page records hold the 4-wide page trees' box floats in
    lanes 0..23 and their codes' bits in lanes 24..27, zeros after, bit
    for bit, and follow the tables to another device."""
    for name in sorted(JAX_SCENES):
        for cut in sorted(CUTS):
            pg = port_scene(name, cut, True)[0].paged
            rec = pg.node.numpy()
            assert rec.shape == (pg.code.shape[0], 32) and rec.dtype == np.float32
            np.testing.assert_array_equal(rec[:, :24].view(np.int32),
                                          pg.box.numpy()[:, :24].view(np.int32))
            np.testing.assert_array_equal(rec[:, 24:28].view(np.int32), pg.code.numpy())
            assert not rec[:, 28:].view(np.int32).any()
            assert torch.equal(pg.to("cpu").node.view(torch.int32), pg.node.view(torch.int32))


def test_binary_page_records_unpack_to_code_and_box():
    """K5's page records hold the binary page trees' 12 box floats in
    lanes 0..11 and their two codes' bits in lanes 12..13, and lanes
    14..15 are zero, so that the walk's int4 code load reads two real
    codes; they follow the tables to another device, and ``paged_from_jax``
    tables carry the same records."""
    for name in sorted(JAX_SCENES):
        for cut in sorted(CUTS):
            pg = port_scene(name, cut, False)[0].paged
            rec = pg.node.numpy()
            assert rec.shape == (pg.code.shape[0], 16) and rec.dtype == np.float32
            np.testing.assert_array_equal(rec[:, :12].view(np.int32),
                                          pg.box.numpy().view(np.int32))
            np.testing.assert_array_equal(rec[:, 12:14].view(np.int32), pg.code.numpy())
            assert not rec[:, 14:].view(np.int32).any()
            assert torch.equal(pg.to("cpu").node.view(torch.int32), pg.node.view(torch.int32))
    theirs = paged.paged_from_jax(jax_table_fields(jax_tables("colonnade", False)),
                                  device="cpu", wide=False)
    np.testing.assert_array_equal(theirs.node.numpy().view(np.int32),
                                  port_scene("colonnade", "tiny", False)[0].paged.node.numpy()
                                  .view(np.int32))


@pytest.mark.parametrize("short_stack", [None, 1])
def test_single_leaf_binary_pages_cast_like_the_plain_version(gxx, short_stack):
    """A page that is one leaf (the two-instance scene's 12-triangle cube,
    and a leaf the icosphere's cut leaves alone under the top tree) is one
    binary node: the leaf as entry 0 and entry 1 absent (code -1, inverted
    +-3e38 box). K5's host build walks those records with the fminf/fmaxf
    slab test and equals the plain version bit for bit on rays aimed at
    each instance from every side, which hit those pages' triangles."""
    scene, _, _ = port_scene("two_instance", "tiny", False)
    pg = scene.paged
    base = pg.node_base.numpy()
    sizes = np.diff(np.append(base, pg.code.shape[0]))
    single = np.nonzero((sizes == 1) & (pg.code.numpy()[base, 1] == -1))[0]
    assert single.size >= 1
    big = np.float32(3.0e38)
    spans = []
    for p in single:
        rec = pg.node[int(base[p])].numpy()
        codes = rec[12:14].view(np.int32)
        assert codes[0] < 0 and codes[1] == -1
        assert (rec[6:9] >= big * 0.99).all() and (rec[9:12] <= -big * 0.99).all()
        first = int(pg.page_tri0[p]) + ((-int(codes[0]) - 1) >> 10)
        spans.append((first, first + ((-int(codes[0]) - 1) & 1023)))
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = torch.from_numpy(dirs)
    for i in range(scene.num_instances):
        o = (scene.inst_pose[i, 0:3][None] - 6.0 * d).contiguous()
        want = paged.cast_rays_paged_torch(scene, o, d)
        assert_hits_equal(host_trace_paged(scene, o, d, "K5", short_stack=short_stack), want)
        if i == 0:
            on_single = sum(((want.tri >= a) & (want.tri < b)).sum() for a, b in spans)
    assert int(on_single) > 0


def test_tables_from_jax_carry_records_that_cast_like_the_ports(gxx):
    """``paged_from_jax`` tables carry K4's page records, and K4's host
    build on them gives the port tables' hits in all three outputs, at
    the default short stack and at one slot."""
    for name in sorted(JAX_SCENES):
        scene, o, d = port_scene(name, "tiny", True)
        theirs = paged.paged_from_jax(jax_table_fields(jax_tables(name, True)), device="cpu")
        np.testing.assert_array_equal(theirs.node.numpy()[:, :28].view(np.int32),
                                      scene.paged.node.numpy()[:, :28].view(np.int32))
        want = paged.cast_rays_paged_torch(scene, o, d)
        for s in (None, 1):
            got = host_trace_paged(dataclasses.replace(scene, paged=theirs), o, d, "K4",
                                   short_stack=s)
            assert_hits_equal(got, want)


@pytest.mark.parametrize("kernel", ["K4", "K6"])
def test_tables_from_jax_cast_like_the_ports(kernel):
    """``paged_from_jax`` tables run through the plain versions give the
    port tables' hits in all three outputs."""
    scene, o, d = port_scene("colonnade", "tiny", True)
    theirs = paged.paged_from_jax(jax_table_fields(jax_tables("colonnade", True)), device="cpu")
    got = PLAIN[kernel](dataclasses.replace(scene, paged=theirs), o, d)
    for a, b in zip(got[:3], PLAIN[kernel](scene, o, d)[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_stats_count_visits():
    """The counters the bounds are computed from: K1 pops and tests, the
    paged walks also pop top-tree nodes, and K6 walks no top tree."""
    scene, o, d = port_scene("colonnade", "deep", True)
    hit, k1 = traversal.cast_rays_wide_torch(scene, o, d, stats=True)
    assert torch.equal(hit.t, traversal.cast_rays_wide_torch(scene, o, d).t)
    _, k4 = paged.cast_rays_paged_torch(scene, o, d, stats=True)
    _, k6 = paged_major.cast_rays_paged_major_torch(scene, o, d, stats=True)
    for s in (k1, k4, k6):
        assert s["pops"].shape == (64 * 64,) and (s["pops"] >= 1).any()
        assert int(s["tests"].sum()) > 0
    assert int(k1["top_pops"].sum()) == 0 and int(k6["top_pops"].sum()) == 0
    assert int(k4["top_pops"].sum()) > 0


@pytest.mark.parametrize("backend", ["paged", "paged_major"])
def test_colonnade_render_through_paged_backends_equals_cuda(backend):
    from tpu_raytracer_torch.app.scenes import scene_colonnade

    scene, cam = scene_colonnade(64, 48, columns=4, segs=8, device="cpu")
    p = cam.ray_params(device="cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    want = render_image(RenderConfig(64, 48, backend="cuda"), scene, *args)
    paged_scene = scene.with_paging(page_tris=512, page_nodes=256)
    got = render_image(RenderConfig(64, 48, backend=backend), paged_scene, *args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the tables are attached once, never built per cast
    with pytest.raises(ValueError, match="with_paging"):
        render_image(RenderConfig(64, 48, backend=backend), scene, *args)
    if backend == "paged":
        np.testing.assert_array_equal(
            render_image_paged(RenderConfig(64, 48), paged_scene, *args).numpy(), want.numpy())
    hit = (want.numpy() != np.array([255, 204, 153], np.uint8)).any(-1).mean()
    assert 0.2 < hit < 0.95


def test_driver_renders_the_colonnade_paged(tmp_path, capsys):
    from tpu_raytracer_torch.app.driver import run

    imgs = [run("colonnade", 32, 32, frames=1, out=str(tmp_path / f"{b}.png"), device="cpu",
                backend=b) for b in ("cuda", "paged", "paged_major")]
    assert capsys.readouterr().out.count("FPS:") == 3
    for img in imgs[1:]:
        np.testing.assert_array_equal(img.numpy(), imgs[0].numpy())


def test_prepare_paged_guards():
    scene, o, d = port_scene("two_instance", "tiny", False)
    with pytest.raises(ValueError, match="page_tris"):
        paged.prepare_paged(scene, page_tris=paged.MAX_PAGE_TRIS + 1)
    with pytest.raises(ValueError, match="page_tris"):
        paged.prepare_paged(scene, page_tris=4)
    with pytest.raises(ValueError, match="capacity"):
        paged.prepare_paged(scene, page_tris=8)  # a 12-triangle leaf spans 16
    with pytest.raises(ValueError, match="4-wide"):
        paged_major.cast_rays_paged_major_torch(scene, o, d)
    with pytest.raises(ValueError, match="with_paging"):
        paged.cast_rays_paged_torch(dataclasses.replace(scene, paged=None), o, d)


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    scene, o, d = port_scene("colonnade", "tiny", True)
    before = dict(build.LAUNCHES)
    for wrapper, plain in ((paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch),
                           (paged_major.cast_rays_paged_major_cuda,
                            paged_major.cast_rays_paged_major_torch)):
        for a, b in zip(wrapper(scene, o, d)[:3], plain(scene, o, d)[:3]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert build.LAUNCHES == before
    moved = scene.to("cpu")
    assert moved.paged.num_pages == scene.paged.num_pages


def test_tile_order_groups_16x16_pixel_tiles():
    perm = paged_major.tile_order((32, 48), "cpu")
    img = torch.arange(32 * 48).reshape(32, 48)
    np.testing.assert_array_equal(perm[:256].numpy(), img[:16, :16].reshape(-1).numpy())
    np.testing.assert_array_equal(perm[256:512].numpy(), img[:16, 16:32].reshape(-1).numpy())
    assert torch.equal(perm.sort().values, torch.arange(32 * 48))
    assert paged_major.tile_order((30, 48), "cpu") is None
    assert paged_major.tile_order((100,), "cpu") is None


def test_entry_points_default_to_the_card(tmp_path):
    """With no card, the entry points fail instead of rendering on the
    CPU: they default to ``cuda``."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from tpu_raytracer_torch.app.scenes import scene_cube\n"
        "from tpu_raytracer_torch.render import Camera\n"
        "for fn in (lambda: scene_cube(16), lambda: Camera.looking(8, 8).ray_params()):\n"
        "    try:\n"
        "        fn()\n"
        "    except (AssertionError, RuntimeError):\n"
        "        continue\n"
        "    raise SystemExit('ran without a card')\n"
    )
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA card")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_differences_from_k1_are_explained_by_box_order():
    """At 128x96 on the small colonnade, K6 keeps another hit than K1 on
    one ray: each hit is accepted by the triangle test, and the nearer
    one lies outside its leaf's box, so K1's walk culled it. Faults the
    check must catch: a triangle that was not hit, and a hit inside its
    box that a cast lost."""
    from tpu_raytracer_torch.app.scenes import scene_colonnade

    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device="cpu")
    scene = scene.with_paging(page_tris=512, page_nodes=256)
    p = cam.ray_params(device="cpu")
    o, d = generate_rays(128, 96, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    k1 = traversal.cast_rays_wide_torch(scene, o, d)
    k6 = paged_major.cast_rays_paged_major_torch(scene, o, d)
    assert int((k6.t != k1.t).sum()) == 1
    assert traversal.unexplained_differences(scene, o, d, k6, k1) == 0
    hits = torch.nonzero((k1.tri >= 0).reshape(-1)).squeeze(1)[:10]
    wrong_tri = k1.tri.clone().reshape(-1)
    wrong_tri[hits] += 1
    assert traversal.unexplained_differences(
        scene, o, d, k1._replace(tri=wrong_tri.reshape(k1.tri.shape)), k1) == 10
    lost = [x.clone().reshape(-1) for x in k1[:3]]
    lost[0][hits], lost[1][hits], lost[2][hits] = FLT_MAX, -1, -1
    assert traversal.unexplained_differences(
        scene, o, d, type(k1)(*(x.reshape(k1.t.shape) for x in lost)), k1) == 10
