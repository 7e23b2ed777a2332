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
    for a, b in zip(whole, per_ray):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    scene = port_scene("cube")
    o, d = port_rays("cube")
    before = traversal.LAUNCHES
    got = traversal.cast_rays_cuda(scene, o, d)
    want = traversal.cast_rays_wide_torch(scene, o, d)
    assert traversal.LAUNCHES == before
    for a, b in zip(got, want):
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
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    no_tlas = dataclasses.replace(scene, tlas=None)
    got = traversal.cast_rays(no_tlas, o, d)
    for a, b in zip(got, traversal.cast_rays_wide_torch(scene, o, d)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    no_wide = dataclasses.replace(port_scene("cube"), wide4=None)
    with pytest.raises(NotImplementedError, match="K4"):
        traversal.cast_rays(no_wide, *port_rays("cube"))
    with pytest.raises(ValueError, match="origin"):
        traversal.cast_rays_cuda(port_scene("cube"), torch.zeros(2), port_rays("cube")[1])


def host_trace(scene, origin, directions, occlusion=False, arity=4):
    """The traversal header of K1 (``arity`` 4, the 4-wide tables) or K2
    (2, the binary tables), built for the host, over every ray."""
    lib = build.load("host")
    tables = scene.wide4
    code, box, root = tables.wcode, tables.wbox, tables.wroot
    if arity == 2:
        code, box, root = scene.binary.code, scene.binary.box, scene.binary.root
    inst_tab = traversal.instance_table(scene)
    inst_root = root[scene.inst_mesh.long()].to(torch.int32).contiguous()
    d = directions.contiguous()
    o = origin.contiguous()
    r = d.numel() // 3
    t = torch.empty(r, dtype=torch.float32)
    tri = torch.empty(r, dtype=torch.int32)
    inst = torch.empty(r, dtype=torch.int32)
    rc = lib.wt_trace_host(
        arity, code.data_ptr(), box.data_ptr(), tables.tri_rec.data_ptr(),
        inst_tab.data_ptr(), inst_root.data_ptr(), ctypes.c_int(scene.num_instances),
        o.data_ptr(), 0 if o.dim() == 1 else 3, d.data_ptr(), r, int(occlusion),
        t.data_ptr(), tri.data_ptr(), inst.data_ptr(),
    )
    assert rc == 0
    return t, tri, inst


@pytest.mark.parametrize("name", ["cube", "two_instance", "blob3"])
def test_kernel_header_host_build_matches_plain_walk(name):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene = port_scene(name)
    o, d = port_rays(name)
    want = traversal.cast_rays_wide_torch(scene, o, d)
    t, tri, inst = host_trace(scene, o, d)
    np.testing.assert_array_equal(t.view(torch.int32).numpy(),
                                  want.t.reshape(-1).view(torch.int32).numpy())
    np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
    np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())
