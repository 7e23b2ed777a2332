"""The carry of kernels K1 and K3 on the CPU: the accepted triangle's
barycentric u, v and face normal n on the hit record, and the carried
branch of ``hit_attributes``, against the JAX package.

The JAX package's TPU kernels carry these fields (``make_test_tri``'s
``carry_uv``/``carry_n``); its CPU tests force them on in interpret mode
with ``TRT_CARRY_UV=1`` (``tests/test_carry_uv.py``), as these do. The
port carries on CUDA tensors; here ``carry=True`` turns the plain
versions' carry on.

Tolerances:
  * t, tri and inst: unchanged by the carry, bit for bit;
  * n: the record's normal, equal bit for bit to ``tri_normal[tri]``
    (selects only), and to the JAX kernels' n;
  * u and v against the JAX kernels' in interpret mode: within
    ``UV_ATOL`` = 1e-4, the bound ``test_carry_uv.py`` holds the carried
    uv to (interpret mode contracts FMAs, which moves u and v by ulps;
    1.05e-5 seen on one ray of config 4);
  * u and v against the port's redo: bit for bit (the plain walk's
    object ray is ``hit_attributes``' to the bit);
  * the host build of the kernels' headers against the plain versions:
    all six fields bit for bit;
  * carried ``hit_attributes`` against the JAX package's carried branch
    on the same hit record: float outputs at rtol 1e-6 (atol 1e-6 for
    values near 0).
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
from tpu_raytracer.kernels.traversal import cast_rays_pallas
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.renderer import Hit as JaxHit
from tpu_raytracer.render.renderer import hit_attributes as jax_hit_attributes
from tpu_raytracer_torch.kernels import build, tlas, traversal
from tpu_raytracer_torch.render import get_cast_fn, hit_attributes
from tpu_raytracer_torch.render.renderer import Hit
from tpu_raytracer_torch.render.sorted_cast import cast_rays_sorted
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_torch_scene import compiled, jax_fields, jax_rays

torch.set_num_threads(1)

UV_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def scene(name: str):
    """(JAX arrays, port scene, origin, directions) of ``instances`` (config
    4 at 64x64: K3), ``cube`` (config 1, textured: K1), ``two_instance``
    (posed, nonuniformly scaled, one textured: K3) or ``blob3``
    (untextured: K1)."""
    if name == "instances":
        ja, cam = jscenes.scene_instances(64, 64)
        p = cam.ray_params()
        o, d = jax_generate_rays(64, 64, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        o, d = np.array(o), np.array(d)
    else:
        ja, _ = compiled(name, "jax")
        o, d = jax_rays(name)
    port = from_scene_arrays(jax_fields(ja), device="cpu")
    return ja, port, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


NAMES = ("instances", "cube", "two_instance", "blob3")


def plain(name, carry_uv=True, carry_n=True, occlusion=False):
    _, sc, o, d = scene(name)
    if sc.tlas is not None:
        return tlas.cast_rays_tlas_torch(sc, o, d, occlusion, carry_uv=carry_uv,
                                         carry_n=carry_n)
    return traversal.cast_rays_wide_torch(sc, o, d, occlusion, carry_uv=carry_uv,
                                          carry_n=carry_n)


def bits(t):
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("name", ["instances", "cube"])
def test_plain_carry_matches_jax_kernel_carry(name, monkeypatch):
    monkeypatch.setenv("TRT_CARRY_UV", "1")
    ja, sc, o, d = scene(name)
    want = cast_rays_pallas(ja, o.numpy(), d.numpy(), interpret=True, want_normals=True)
    assert want.u is not None and want.n is not None
    got = traversal.cast_rays(sc, o, d, want_normals=True, carry=True)
    assert got.u is not None and got.n is not None
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6, atol=1e-6)
    same = ((got.tri.numpy() == np.asarray(want.tri)) & (got.inst.numpy() == np.asarray(want.inst))
            & (got.tri.numpy() >= 0))
    # a different triangle only at an exact-t tie
    assert same.sum() >= (got.tri.numpy() >= 0).sum() - 2
    assert same.mean() > 0.1
    np.testing.assert_array_equal(got.n.numpy()[same], np.asarray(want.n)[same])
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=0, atol=UV_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_carry_leaves_t_tri_inst_unchanged(name):
    with_carry, without = plain(name), plain(name, False, False)
    assert without.u is None and without.n is None
    np.testing.assert_array_equal(bits(with_carry.t), bits(without.t))
    np.testing.assert_array_equal(with_carry.tri.numpy(), without.tri.numpy())
    np.testing.assert_array_equal(with_carry.inst.numpy(), without.inst.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_carried_normal_is_the_record_normal(name):
    _, sc, _, _ = scene(name)
    h = plain(name)
    hit = h.tri >= 0
    want = sc.tri_normal[h.tri.clamp(min=0).long()]
    np.testing.assert_array_equal(bits(h.n[hit]), bits(want[hit]))
    # a miss keeps the carry's zero start
    assert not h.n[~hit].any() and not h.u[~hit].any() and not h.v[~hit].any()
    assert hit.any()


@pytest.mark.parametrize("name", NAMES)
def test_carried_uv_equals_the_redo(name):
    """The redo of ``hit_attributes`` and the walk build the same object
    ray and the same affine barycentric rows, so the carried u, v and the
    plane point from t are the redo's to the bit."""
    _, sc, o, d = scene(name)
    h = plain(name)
    carried = hit_attributes(sc, o, d, h)
    redo = hit_attributes(sc, o, d, Hit(h.t, h.tri, h.inst))
    for a, b in zip(carried, redo):
        np.testing.assert_array_equal(a[carried.hit].numpy(), b[redo.hit].numpy())


def host_trace(name, short_stack=None, occlusion=False, fields=(True, True, True)):
    """The kernels' headers built for the host with the carry: (rc, t, tri,
    inst, u, v, n)."""
    _, sc, o, d = scene(name)
    lib = build.load("host", short_stack)
    w = sc.wide4
    inst_tab = traversal.instance_table(sc)
    inst_root = w.wroot[sc.inst_mesh.long()].to(torch.int32).contiguous()
    d = d.contiguous()
    r = d.numel() // 3
    t = torch.empty(r, dtype=torch.float32)
    tri = torch.empty(r, dtype=torch.int32)
    inst = torch.empty(r, dtype=torch.int32)
    u, v, n = torch.empty(r), torch.empty(r), torch.empty(r, 3)
    outs = [x.data_ptr() if want else None for x, want in zip((u, v, n), fields)]
    spills = ctypes.c_int64(-1)
    head = [w.wnode.data_ptr(), w.tri_rec.data_ptr(), inst_tab.data_ptr(), inst_root.data_ptr(),
            sc.num_instances]
    tail = [o.data_ptr(), 0, d.data_ptr(), r, int(occlusion), t.data_ptr(), tri.data_ptr(),
            inst.data_ptr(), *outs]
    if sc.tlas is not None:
        tl = sc.tlas
        rc = lib.tlas_trace_host(*head, tl.code.data_ptr(), tl.box.data_ptr(),
                                 tl.inst_ids.data_ptr(), *tail, ctypes.byref(spills))
    else:  # K1's carrying walk is unbounded
        rc = lib.wt_trace_host(4, *head, *tail, traversal.BIG, ctypes.byref(spills))
    return rc, t, tri, inst, u, v, n


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("short_stack", [None, 1])
@pytest.mark.parametrize("name", NAMES)
def test_host_build_carry_matches_plain_bitwise(gxx, name, short_stack):
    rc, t, tri, inst, u, v, n = host_trace(name, short_stack)
    assert rc == 0
    want = plain(name)
    for a, b in ((t, want.t), (u, want.u), (v, want.v), (n, want.n)):
        np.testing.assert_array_equal(bits(a), bits(b.reshape(a.shape)))
    np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
    np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())


@pytest.mark.parametrize("name", ["cube", "instances"])
def test_carry_with_occlusion_raises(gxx, name):
    with pytest.raises(ValueError, match="occlusion"):
        plain(name, occlusion=True)
    with pytest.raises(ValueError, match="occlusion"):
        plain(name, carry_uv=False, occlusion=True)
    assert host_trace(name, occlusion=True)[0] == 1
    _, sc, o, d = scene(name)
    # the routing gate turns the carry off for any hit, as the JAX gate does
    occ = traversal.cast_rays(sc, o, d, occlusion=True, want_normals=True, carry=True)
    assert occ.u is None and occ.n is None


def test_carry_gate_follows_the_jax_package():
    _, tex, o, d = scene("cube")
    _, untex, _, _ = scene("blob3")
    assert traversal.carry_fields(tex, d, False) == (False, False)  # CPU: off
    assert traversal.carry_fields(tex, d, False, True, carry=True) == (True, True)
    assert traversal.carry_fields(tex, d, False, False, carry=True) == (True, False)
    assert traversal.carry_fields(untex, d, False, True, carry=True) == (False, True)
    assert traversal.carry_fields(tex, d, True, True, carry=True) == (False, False)
    # the cuda backend's cast takes want_normals; CPU tensors carry nothing
    # unless asked; the other backends ignore the request
    h = get_cast_fn("cuda", want_normals=True)(tex, o, d)
    assert h.u is None and h.n is None
    h = get_cast_fn("cuda", want_normals=True)(tex, o, d, carry=True)
    assert h.u is not None and h.n is not None and h.n.shape == d.shape
    assert get_cast_fn("bvh", want_normals=True)(tex, o, d).n is None


def test_sorted_cast_keeps_the_carried_fields():
    _, sc, o, d = scene("two_instance")
    cast = functools.partial(traversal.cast_rays, want_normals=True, carry=True)
    got = cast_rays_sorted(cast, sc, o, d)
    want = cast(sc, o, d)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fields", ["uv_n", "uv", "n"])
@pytest.mark.parametrize("name", ["instances", "two_instance", "blob3"])
@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
def test_carried_hit_attributes_match_jax(name, fields, normal_mode):
    ja, sc, o, d = scene(name)
    h = plain(name, carry_uv="uv" in fields, carry_n="n" in fields)
    if h.u is None and h.n is None:
        pytest.skip("an untextured scene carries no uv")
    jhit = JaxHit(*(None if x is None else x.numpy() for x in h))
    want = jax_hit_attributes(ja, o.numpy(), d.numpy(), jhit, normal_mode=normal_mode)
    got = hit_attributes(sc, o, d, h, normal_mode=normal_mode)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(want.hit))
    for key in ("location", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, key).numpy()[hit],
                                   np.asarray(getattr(want, key))[hit], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.material.numpy(), np.asarray(want.material))
