"""Kernels K1-K6 on a CUDA card against their plain PyTorch versions
(also with their short stack cut to one slot, so that entries take the
spill path), K6's card plan against its plain plan and K6's cast with
no host sync, the config 5 path frame through K2 and K1, and the
carrying kernels of K1 and K3 (u, v and n) with the lit frames they
serve, K1 on a flattened scene, K1, K4 and K6 on a presplit colonnade,
the PNG and OBJ readers on a machine without OpenCV or PIL, the
big-scene route (a scene past the leaf code's rows cast by K4 alone), and
the frame stages' kernels S1 (raygen), S2 (hit attributes), S3 (primary
shade), S4 (the path tracer's and AO's sample draws), S5 (the Whitted
shade) and S6 (the path tracer's bounce) bit for bit against their plain
versions, misses included, and K1 and K2 bounded by
AO's radius against their bounded plain versions, with the bounded
launches a compiled AO frame counts.

Marked ``gpu``: every test skips without a card. On a machine with one
(and no JAX), run from the repository root with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py configures JAX, which this file
does not use). The kernels are built with --fmad=false, so they must
equal their plain versions bit for bit; their any-hit answers must equal the
nearest-hit casts' blocked/clear answers. The cube must equal its exact
CPU golden; the config 4 Whitted image and the carried lit frames of
configs 2 and 3 may differ from their CPU goldens in at most 4 pixels,
since PyTorch's CUDA rsqrt and pow need not round as the CPU's do (the
JAX package allows its TPU the same 4).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from tpu_raytracer_torch.app.scenes import (
    scene_colonnade, scene_colonnade_pair, scene_cube, scene_instances,
)
from tpu_raytracer_torch.core.vecmath import FLT_MAX, normalize
from tpu_raytracer_torch.kernels import binary, build, paged, paged_major, tlas, traversal
from tpu_raytracer_torch.kernels.build import LAUNCHES
from tpu_raytracer_torch.render import (
    Camera, RenderConfig, generate_rays, hit_attributes, render, render_image_whitted,
)
from tpu_raytracer_torch.render.integrators import _reflect
from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION, SHADOW_EPS, SKY_COLOR
from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

pytestmark = pytest.mark.gpu

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "config1_cube_64.npy")


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
    before = LAUNCHES["K1"]
    got = traversal.cast_rays_cuda(scene, o, d)
    torch.cuda.synchronize()
    assert LAUNCHES["K1"] == before + 1
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


def _secondary_rays(scene, o, d, hit):
    """(reflection, shadow) rays from the primary hits, dead rays parked."""
    attrs = hit_attributes(scene, o, d, hit)
    rd = normalize(_reflect(d, attrs.normal))
    refl = park_dead_rays(attrs.location + rd * SHADOW_EPS, rd, attrs.hit)
    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32, device=d.device))
    shadow = park_dead_rays(attrs.location + ldir * SHADOW_EPS,
                            ldir.expand(attrs.location.shape), attrs.hit)
    return refl, shadow


def test_k3_matches_plain_version_bitwise(cuda):
    scene, cam = scene_instances(256, 256, device=cuda)
    o, d = _rays(cam, cuda)
    before = LAUNCHES["K3"]
    got = tlas.cast_rays_tlas_cuda(scene, o, d)
    torch.cuda.synchronize()
    assert LAUNCHES["K3"] == before + 1
    refl, _ = _secondary_rays(scene, o, d, got)
    for ro, rd, hit in ((o, d, got), (*refl, tlas.cast_rays_tlas_cuda(scene, *refl))):
        want = tlas.cast_rays_tlas_torch(scene, ro, rd)
        assert (hit.tri >= 0).any()
        assert torch.equal(hit.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(hit.tri, want.tri)
        assert torch.equal(hit.inst, want.inst)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_any_hit_matches_nearest_hit(cuda, kernel):
    scene, cam = scene_instances(256, 256, device=cuda)
    o, d = _rays(cam, cuda)
    cast = traversal.cast_rays_cuda if kernel == "K1" else tlas.cast_rays_tlas_cuda
    _, (so, sd) = _secondary_rays(scene, o, d, cast(scene, o, d))
    nearest = cast(scene, so, sd)
    occ = cast(scene, so, sd, occlusion=True)
    blocked = nearest.t < FLT_MAX
    assert blocked.any() and not blocked.all()
    assert torch.equal(occ.t < 0, blocked)
    assert torch.equal(occ.t >= FLT_MAX, ~blocked)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_short_stack_spill_path_matches_plain_version(cuda, kernel):
    """K1, K2 and K3 with their short stack cut to 1 ring slot, so that
    every ray holding two entries spills to local memory: bitwise equal to
    their plain versions on primary and reflection rays, and any-hit
    answers equal to the plain any-hit cast's."""
    if kernel == "K1":
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
        cast, plain = traversal.cast_rays_cuda, traversal.cast_rays_wide_torch
    elif kernel == "K2":
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
        cast, plain = binary.cast_rays_binary_cuda, binary.cast_rays_binary_torch
    else:
        scene, cam = scene_instances(256, 256, device=cuda)
        cast, plain = tlas.cast_rays_tlas_cuda, tlas.cast_rays_tlas_torch
    o, d = _rays(cam, cuda)
    refl, shadow = _secondary_rays(scene, o, d, cast(scene, o, d))
    for ro, rd in ((o, d), refl):
        before = LAUNCHES[kernel]
        got = cast(scene, ro, rd, short_stack=1)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel] == before + 1
        want = plain(scene, ro, rd)
        assert (got.tri >= 0).any()
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
    occ = cast(scene, *shadow, occlusion=True, short_stack=1)
    want_occ = plain(scene, *shadow, occlusion=True)
    assert torch.equal(occ.t, want_occ.t)
    assert (occ.t < 0).any() and (occ.t >= FLT_MAX).any()
    with pytest.raises(ValueError, match="short_stack"):
        cast(scene, o, d, short_stack=3)


def test_config4_whitted_within_four_pixels_of_cpu_golden(cuda):
    scene, cam = scene_instances(64, 64, device=cuda)
    p = cam.ray_params(cuda)
    before = LAUNCHES["K3"]
    img = render_image_whitted(RenderConfig(64, 64), scene, p["K_inv"], p["D"], p["pose"],
                               p["inv_pose"])
    assert LAUNCHES["K3"] >= before + 3
    golden = np.load(os.path.join(GOLDEN_DIR, "config4_instances_whitted_64.npy"))
    assert (img.cpu().numpy() != golden).any(-1).sum() <= 4


def _carry_sets(device):
    """(kernel, scene, origin, directions) of the carry tests: K1 on the
    textured cube and the untextured pair, K3 on config 4's primary and
    reflection rays."""
    cube, cam = scene_cube(64, device=device)
    pair, pcam = _two_instance(device)
    inst, icam = scene_instances(256, 256, device=device)
    o, d = _rays(icam, device)
    refl, _ = _secondary_rays(inst, o, d, tlas.cast_rays_tlas_cuda(inst, o, d))
    return [("K1", cube, *_rays(cam, device)), ("K1", pair, *_rays(pcam, device)),
            ("K3", inst, o, d), ("K3", inst, *refl)]


@pytest.mark.parametrize("short_stack", [None, 1])
def test_carrying_kernels_match_plain_versions_bitwise(cuda, short_stack):
    """K1's and K3's carrying kernels: t, tri, inst, u, v and n equal to
    the plain versions' with the same carry, bit for bit, also through
    the short stack's spill path; the carry changes no t, tri or inst."""
    for kernel, scene, o, d in _carry_sets(cuda):
        cast, plain = (
            (traversal.cast_rays_cuda, traversal.cast_rays_wide_torch)
            if kernel == "K1" else (tlas.cast_rays_tlas_cuda, tlas.cast_rays_tlas_torch))
        uv, n = traversal.carry_fields(scene, d, False, True)
        assert n and uv == scene.has_textures
        before = (LAUNCHES[kernel], LAUNCHES[kernel + "_carry"])
        got = cast(scene, o, d, short_stack=short_stack, want_normals=True)
        bare = cast(scene, o, d, short_stack=short_stack, carry=False)
        torch.cuda.synchronize()
        assert (LAUNCHES[kernel], LAUNCHES[kernel + "_carry"]) == (before[0] + 2, before[1] + 1)
        want = plain(scene, o, d, carry_uv=uv, carry_n=n)
        assert (got.tri >= 0).any() and got.n is not None and (got.u is not None) == uv
        for a, b, c in zip(got, want, tuple(bare) + (None,) * 3):
            if b is None:
                assert a is None
                continue
            bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x
            assert torch.equal(bits(a), bits(b))
            if c is not None:
                assert torch.equal(bits(a), bits(c))


def test_carry_refuses_any_hit_and_keeps_its_launch_shape(cuda):
    scene, cam = scene_cube(64, device=cuda)
    o, d = _rays(cam, cuda)
    with pytest.raises(ValueError, match="occlusion"):
        traversal.launch("wt_launch", scene, o, d, True, arity=4, carry_n=True)
    occ = traversal.cast_rays_cuda(scene, o, d, occlusion=True, want_normals=True)
    assert occ.u is None and occ.n is None
    for kernel in ("K1", "K3"):
        carry = traversal.launch_shape(kernel, False, 1920 * 1088, carry=True)
        bare = traversal.launch_shape(kernel, False, 1920 * 1088)
        assert carry["threads"] == bare["threads"]
        assert carry["shared_bytes"] == bare["shared_bytes"]
        assert carry["blocks_per_sm"] >= 1


@pytest.mark.parametrize("golden,lighting", [("config2_cornell_64", "lambert_shadow"),
                                             ("config3_bunny_96", "blinn_phong")])
def test_carried_lit_frames_within_four_pixels_of_cpu_golden(cuda, golden, lighting):
    from tpu_raytracer_torch.app.scenes import scene_bunny, scene_cornell
    from tpu_raytracer_torch.render import render_image

    scene, cam = (scene_cornell(64, device=cuda) if golden.startswith("config2")
                  else scene_bunny(96, 96, subdivisions=4, device=cuda))
    p = cam.ray_params(cuda)
    carrying = "K3_carry" if scene.num_instances >= 2 else "K1_carry"
    before = LAUNCHES[carrying]
    img = render_image(RenderConfig(cam.width, cam.height, lighting=lighting), scene,
                       p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    assert LAUNCHES[carrying] == before + 1  # the primary cast carried the normal
    want = np.load(os.path.join(GOLDEN_DIR, golden + ".npy"))
    assert (img.cpu().numpy() != want).any(-1).sum() <= 4


PAGED = {
    "K4": (True, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch),
    "K5": (False, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch),
    "K6": (True, paged_major.cast_rays_paged_major_cuda, paged_major.cast_rays_paged_major_torch),
}


def _paged_scene(which, device, wide=True):
    """The small colonnade or the two-instance pair, paged, and its camera."""
    if which == "colonnade":
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=device)
    else:
        scene, cam = scene_colonnade_pair(96, 64, columns=3, segs=8, device=device)
    return scene.with_paging(page_tris=512, page_nodes=256, wide=wide), cam


@pytest.mark.parametrize("which", ["colonnade", "pair"])
@pytest.mark.parametrize("kernel", sorted(PAGED))
def test_paged_kernels_match_plain_versions_bitwise(cuda, kernel, which):
    wide, cast, plain = PAGED[kernel]
    scene, cam = _paged_scene(which, cuda, wide)
    o, d = _rays(cam, cuda)
    refl, _ = _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    for ro, rd in ((o, d), refl):
        before = LAUNCHES[kernel]
        got = cast(scene, ro, rd)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel] == before + 1
        want = plain(scene, ro, rd)
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
        k1 = traversal.cast_rays_cuda(scene, ro, rd)
        assert traversal.unexplained_differences(scene, ro, rd, got, k1) == 0
    assert (got.tri >= 0).any()


@pytest.mark.parametrize("which", ["colonnade", "pair"])
def test_k4_short_stack_spill_path_matches_plain_version(cuda, which):
    """K4 with its short stack cut to 1 ring slot, so that top-tree and
    page entries spill to local memory: bitwise equal to its plain version
    on primary and reflection rays."""
    scene, cam = _paged_scene(which, cuda)
    o, d = _rays(cam, cuda)
    refl, _ = _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    for ro, rd in ((o, d), refl):
        before = LAUNCHES["K4"]
        got = paged.cast_rays_paged_cuda(scene, ro, rd, short_stack=1)
        torch.cuda.synchronize()
        assert LAUNCHES["K4"] == before + 1
        want = paged.cast_rays_paged_torch(scene, ro, rd)
        assert (got.tri >= 0).any()
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
    with pytest.raises(ValueError, match="short_stack"):
        paged.cast_rays_paged_cuda(scene, o, d, short_stack=3)


@pytest.mark.parametrize("which", ["colonnade", "pair"])
@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_k5_k6_short_stack_spill_path_matches_plain_version(cuda, kernel, which):
    """K5 and K6 with their short stack cut to 1 ring slot: bitwise equal
    to their plain versions on primary and reflection rays."""
    wide, cast, plain = PAGED[kernel]
    scene, cam = _paged_scene(which, cuda, wide)
    o, d = _rays(cam, cuda)
    refl, _ = _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    for ro, rd in ((o, d), refl):
        before = LAUNCHES[kernel]
        got = cast(scene, ro, rd, short_stack=1)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel] == before + 1
        want = plain(scene, ro, rd)
        assert (got.tri >= 0).any()
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
    with pytest.raises(ValueError, match="short_stack"):
        cast(scene, o, d, short_stack=3)


@pytest.mark.parametrize("which", ["colonnade", "pair"])
def test_card_plan_equals_plain_plan(cuda, which):
    """K6's plan from the card's kernels equals the plain plan bit for bit:
    the seen items in the same order, then the unseen ones, and every
    tile's list, on primary rays (tile order) and reflection rays."""
    scene, cam = _paged_scene(which, cuda)
    o, d = _rays(cam, cuda)
    refl, _ = _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    for ro, rd in ((o, d), refl):
        _, to, td = paged_major._tile_rays(ro, rd)
        pid, iid, mask = paged_major.page_major_plan(scene, to, td)
        start, items = paged_major.tile_lists(mask)
        before = LAUNCHES["K6_plan"]
        c_pid, c_iid, c_start, c_items = paged_major.page_major_plan_cuda(scene, to, td)
        torch.cuda.synchronize()
        assert LAUNCHES["K6_plan"] == before + 1
        n = pid.shape[0]
        assert n > 0 and c_pid.shape[0] == scene.num_instances * scene.paged.num_pages
        assert torch.equal(c_pid[:n], pid) and torch.equal(c_iid[:n], iid)
        assert torch.equal(c_start, start)
        assert torch.equal(c_items[:items.shape[0]], items)


def test_k6_cast_waits_on_the_host_for_nothing(cuda):
    """K6's cast, its plan included, makes no call that synchronises with
    the host (``torch.cuda.set_sync_debug_mode("error")`` raises on one),
    and still equals its plain version."""
    scene, cam = _paged_scene("pair", cuda)
    o, d = _rays(cam, cuda)
    paged_major.cast_rays_paged_major_cuda(scene, o, d)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = paged_major.cast_rays_paged_major_cuda(scene, o, d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = paged_major.cast_rays_paged_major_torch(scene, o, d)
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)


@pytest.mark.parametrize("backend", ["paged", "paged_major"])
def test_colonnade_renders_through_paged_backends_as_through_cuda(cuda, backend):
    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    p = cam.ray_params(cuda)
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    from tpu_raytracer_torch.render import render_image

    want = render_image(RenderConfig(128, 96), scene, *args)
    got = render_image(RenderConfig(128, 96, backend=backend), scene.with_paging(), *args)
    assert torch.equal(got, want)


def test_k2_matches_plain_version_bitwise_in_both_modes(cuda):
    scene, cam = _two_instance(cuda)
    o, d = _rays(cam, cuda)
    refl, shadow = _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    for ro, rd in ((o, d), refl):
        before = LAUNCHES["K2"]
        got = binary.cast_rays_binary_cuda(scene, ro, rd)
        torch.cuda.synchronize()
        assert LAUNCHES["K2"] == before + 1
        want = binary.cast_rays_binary_torch(scene, ro, rd)
        assert (got.tri >= 0).any()
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
        k1 = traversal.cast_rays_cuda(scene, ro, rd)
        assert traversal.unexplained_differences(scene, ro, rd, got, k1) == 0
    occ = binary.cast_rays_binary_cuda(scene, *shadow, occlusion=True)
    plain = binary.cast_rays_binary_torch(scene, *shadow, occlusion=True)
    near = binary.cast_rays_binary_cuda(scene, *shadow)
    assert torch.equal(occ.t, plain.t)
    assert torch.equal(occ.t < 0, near.t < FLT_MAX)


def _plain_casts(monkeypatch):
    """Route the bvh and cuda backends to their plain versions."""
    from tpu_raytracer_torch.render import renderer

    real = renderer.get_cast_fn

    def plain(backend, want_normals=False):
        if backend == "bvh":
            return binary.cast_rays_binary_torch
        if backend == "cuda":
            def cast(sc, o, d, occlusion=False):
                # what the kernels carry on these rays
                uv, n = traversal.carry_fields(sc, d, occlusion, want_normals)
                plain_cast = (tlas.cast_rays_tlas_torch if sc.num_instances >= 2
                              else traversal.cast_rays_wide_torch)
                return plain_cast(sc, o, d, occlusion, carry_uv=uv, carry_n=n)
            return cast
        return real(backend, want_normals)

    from tpu_raytracer_torch.render import integrators

    monkeypatch.setattr(renderer, "get_cast_fn", plain)
    monkeypatch.setattr(integrators, "get_cast_fn", plain)


@pytest.mark.parametrize("backend", ["bvh", "cuda"])
def test_config5_path_frame_matches_plain_casts(cuda, backend, monkeypatch):
    from tpu_raytracer_torch.render import render_image_path_traced
    from tpu_raytracer_torch.utils import prng

    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    p = cam.ray_params(cuda)
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"], prng.PRNGKey(7), 2, 2)
    config = RenderConfig(128, 96, backend=backend)
    build.reset_launches()
    img = render_image_path_traced(config, scene, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["K2" if backend == "bvh" else "K1"] == 3
    with monkeypatch.context() as m:
        _plain_casts(m)
        want = render_image_path_traced(config, scene, *args)
    assert torch.equal(img, want)
    golden = np.load(os.path.join(GOLDEN_DIR, "config5_colonnade_path_64.npy"))
    scene64, cam64 = scene_colonnade(64, 64, columns=4, segs=8, device=cuda)
    p64 = cam64.ray_params(cuda)
    img64 = render_image_path_traced(RenderConfig(64, 64, backend=backend), scene64,
                                     p64["K_inv"], p64["D"], p64["pose"], p64["inv_pose"],
                                     prng.PRNGKey(7), 2, 2)
    assert (img64.cpu().numpy() != golden).any(-1).sum() <= 16  # tests/test_torch_path.py


def test_sorted_cast_equals_unsorted_cast_on_the_card(cuda):
    from tpu_raytracer_torch.render.integrators import _cosine_sample
    from tpu_raytracer_torch.render.sorted_cast import cast_rays_sorted
    from tpu_raytracer_torch.utils import prng

    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    o, d = _rays(cam, cuda)
    attrs = hit_attributes(scene, o, d, traversal.cast_rays_cuda(scene, o, d))
    nd = _cosine_sample(prng.PRNGKey(1), attrs.normal, True)
    ro, rd = park_dead_rays(attrs.location + nd * SHADOW_EPS, nd, attrs.hit)
    want = traversal.cast_rays_cuda(scene, ro, rd)
    got = cast_rays_sorted(traversal.cast_rays_cuda, scene, ro, rd)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


def test_k1_on_a_flattened_scene_matches_plain_version(cuda):
    """Config 4 baked to one mesh: K1 carrying u, v and n on every ray,
    bitwise against its plain version, and no K3 launch in its frame."""
    scene, cam = scene_instances(128, 96, device=cuda, flatten=True)
    assert scene.num_instances == 1 and int(scene.tri_mat.max()) == 3
    o, d = _rays(cam, cuda)
    for ro, rd in ((o, d), _secondary_rays(scene, o, d, traversal.cast_rays_cuda(scene, o, d))[0]):
        uv, n = traversal.carry_fields(scene, rd, False, True, True)
        got = traversal.cast_rays_cuda(scene, ro, rd, want_normals=True, carry=True)
        want = traversal.cast_rays_wide_torch(scene, ro, rd, carry_uv=uv, carry_n=n)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                   b.view(torch.int32) if b.is_floating_point() else b)
    build.reset_launches()
    p = cam.ray_params(cuda)
    render_image_whitted(RenderConfig(128, 96), scene, p["K_inv"], p["D"], p["pose"],
                         p["inv_pose"])
    torch.cuda.synchronize()
    assert LAUNCHES["K1"] == 6 and LAUNCHES["K3"] == 0


def test_k1_k4_k6_on_a_presplit_colonnade_match_plain_versions(cuda):
    """Duplicated triangle references and clipped boxes: the 8-aligned
    leaves, the page cut and K6's plan all see more leaf rows than
    triangles."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    v = procgen.colonnade(4, 4, 8)
    scene.add_mesh(MeshPrimitive.from_triangles(*v, presplit=1.3))
    scene.add_mesh_instance(MeshInstance(0, 0))
    base = scene.compile(cuda)
    assert int(base.node_leaf_count[base.node_child_a < 0].sum()) > len(v[0])
    cam = Camera.looking(128, 96, fov_deg=65.0, pose=[1.0, -2.0, 1.6, 0, 0, 0])
    o, d = _rays(cam, cuda)
    k1 = traversal.cast_rays_cuda(base, o, d)
    k1_plain = traversal.cast_rays_wide_torch(base, o, d)
    assert torch.equal(k1.t.view(torch.int32), k1_plain.t.view(torch.int32))
    assert torch.equal(k1.tri, k1_plain.tri)
    for kernel in ("K4", "K6"):
        _, cast, plain = PAGED[kernel]
        paged_scene = base.with_paging(page_tris=512, page_nodes=256)
        got, want = cast(paged_scene, o, d), plain(paged_scene, o, d)
        assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
        assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
        assert traversal.unexplained_differences(base, o, d, got, k1) == 0


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img, color_type, filters, palette=None, depth=8, interlace=0) -> bytes:
    """An 8-bit PNG of ``img`` [H, W, C] whose row r uses filter
    ``filters[r % len(filters)]`` (0 none, 1 sub, 2 up, 3 average, 4
    Paeth); ``palette`` [N, 3] for colour type 3."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    raw = img.reshape(h, w * bpp).astype(np.int64)
    prev = np.zeros(w * bpp, np.int64)
    rows = []
    for r in range(h):
        f = filters[r % len(filters)]
        x = raw[r]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][f]
        rows.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                                            0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


def test_png_texture_and_obj_file_on_the_card_machine(cuda, tmp_path, monkeypatch):
    """``decode_png`` (numpy and zlib, what ``read_png`` falls back to
    where OpenCV does not import) on all five filters, the textured cube
    from a PNG file, read through ``cv2.imread`` where OpenCV imports and
    through ``decode_png`` with OpenCV blocked, against the in-memory
    texture's frame, and an OBJ file through the native parser."""
    import sys

    from tpu_raytracer_torch.scene import objloader
    from tpu_raytracer_torch.utils.image import decode_png

    tex = procgen.checkerboard_texture(64, 8)  # BGR
    rgb = np.ascontiguousarray(tex[..., ::-1])
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        assert np.array_equal(decode_png(encode_png(rgb, 2, filters)), tex)
    fp = tmp_path / "checker.png"
    fp.write_bytes(encode_png(rgb, 2, [0, 1, 2, 3, 4]))
    frames = []
    for source in ("memory", "file", "file_without_opencv"):
        scene = Scene()
        mat = Material()
        if source == "memory":
            mat.set_texture(tex)
        else:
            with monkeypatch.context() as m:
                if source == "file_without_opencv":
                    m.setitem(sys.modules, "cv2", None)
                mat.upload_texture(str(fp))
        scene.add_material(mat)
        scene.add_mesh(objloader.loads(procgen.cube_obj()))
        scene.add_mesh_instance(MeshInstance(0, 0))
        cam = Camera.looking(256, 256, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
        frames.append(render(cam, scene.compile(cuda), backend="cuda"))
    assert torch.equal(frames[0], frames[1]) and torch.equal(frames[0], frames[2])
    text = "".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for tri in zip(*procgen.blob(subdivisions=5))
                   for x, y, z in tri)
    text += "".join(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n" for k in range(20480))
    assert len(text) > objloader.NATIVE_OBJ_THRESHOLD
    (tmp_path / "blob.obj").write_text(text)
    got = objloader.load(str(tmp_path / "blob.obj"))
    want = objloader.parse_obj(text, native=False)
    assert got.num_triangles == 20480
    assert np.array_equal(got.v0, want[0][got.bvh.order])


def _pair_host():
    """The two-instance scene of ``_two_instance`` before compiling."""
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
    return scene, Camera.looking(128, 96, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_cast_and_row_bands_on_the_card(cuda, world, backend):
    """Ranks on ``cuda:0`` (NCCL at one rank; gloo at two, which share
    the card): the scene-sharded cast through K1 equals the plain casts of
    the same chunks combined here (the lexicographic (t, global tri)
    minimum), bit for bit, and the row-band frame (K3) equals
    ``render_image``."""
    import functools

    from tpu_raytracer_torch.parallel import (
        PerRank, cast_rays_scene_sharded, render_image_sharded, shard_compile, spawn,
    )
    from tpu_raytracer_torch.parallel.group import run_calls
    from tpu_raytracer_torch.render import render_image

    host, cam = _pair_host()
    shards = shard_compile(host, world, device="cpu")
    compiled = host.compile("cpu")
    o, d = _rays(cam, "cpu")
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    cfg = RenderConfig(128, 96, backend="cuda")
    calls = [(world, cast_rays_scene_sharded, (PerRank(tuple(shards)), o, d, "cuda")),
             (world, functools.partial(render_image_sharded, cfg), (compiled, *args))]
    ranks = spawn(run_calls, world, args=(calls,), device="cuda:0", backend=backend)
    hit, img = ranks[0]
    for other_hit, other_img in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other_hit[:3], hit[:3]))
        assert torch.equal(other_img, img)
    # the plain casts of the chunks, combined by sorting on (t, global tri)
    keys = []
    for s in shards:
        h = traversal.cast_rays_wide_torch(s.scene.to(cuda), o.to(cuda), d.to(cuda))
        gtri = torch.where(h.tri >= 0, h.tri.long() + s.shard * s.stride, 2 ** 30)
        keys.append((h.t.view(torch.int32).long() << 32) | gtri)
    best = torch.stack(keys).min(dim=0).values.cpu()
    assert torch.equal(hit.t.view(torch.int32), (best >> 32).to(torch.int32))
    gtri = best & 0xFFFFFFFF
    assert torch.equal(hit.tri.long(), torch.where(gtri >= 2 ** 30, -1, gtri))
    assert torch.equal(hit.inst.long(), torch.where(gtri >= 2 ** 30, -1, 0))
    assert (hit.tri >= 0).float().mean() > 0.2
    want = render_image(cfg, compiled.to(cuda), *(a.to(cuda) for a in args))
    assert torch.equal(img, want.cpu())


def _sharded_poses(cam, n: int) -> list:
    start = cam.pose.copy()
    out = []
    for step in range(n):
        cam.pose = start + np.float32(0.05 * step) * np.array([1, 1, 0.5, 1, 0.2, 0],
                                                             np.float32)
        p = cam.ray_params("cpu")
        out.append((p["K_inv"], p["D"], p["pose"], p["inv_pose"]))
    cam.pose = start
    return out


def compiled_sharded_rank(group, cases: dict) -> dict:
    """A ``spawn`` worker: per case, the compiled entry point's frame and
    the eager frame at each pose, bitwise; the eager frame's launches
    against the launches of a replay; or, where the compiled entry point
    refuses the group, its ``ValueError``."""
    from tpu_raytracer_torch.parallel import scene_shard, sharding
    from tpu_raytracer_torch.parallel.group import to_device
    from tpu_raytracer_torch.render.compiled import launch_counts

    out = {}
    for name, (mod, entry, cfg, scene, poses, extra) in cases.items():
        mod = {"rows": sharding, "shards": scene_shard}[mod]
        eager, fast = getattr(mod, entry), getattr(mod, "compiled_" + entry)
        scene, extra = to_device((scene, extra), group.device)
        same, launches = [], []
        try:
            for args in poses:
                args = to_device(args, group.device)
                got = fast(cfg, group, scene, *args, *extra)
                before = launch_counts()
                want = eager(cfg, group, scene, *args, *extra)
                torch.cuda.synchronize()
                after = launch_counts()
                same.append(torch.equal(got, want))
                launches.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        except ValueError as e:
            out[name] = str(e)
            continue
        entry_ = fast.last
        out[name] = {"same": same, "eager_launches": launches, "replay": entry_.launches,
                     "entries": len(fast.entries), "graph": entry_.graph is not None,
                     "replays": entry_.replays}
    return out


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_compiled_sharded_entries_replay_the_eager_frames(cuda, world, backend):
    """The six compiled sharded entry points on ranks on ``cuda:0``: each
    rank captures its frame once and replays it at 2 poses, each frame
    bitwise the eager entry's, a replay launching what the eager frame
    does. At one NCCL rank the scene shards' graphs hold the combine's
    collectives; on two gloo ranks (which share the card) the row bands
    are captured and gathered after the replay through host memory, and
    the scene shards' compiled entry points raise naming NCCL."""
    from tpu_raytracer_torch.parallel import PerRank, shard_compile, spawn
    from tpu_raytracer_torch.utils import prng

    host, cam = _pair_host()
    rows = host.compile("cpu")
    chunks = PerRank(tuple(shard_compile(host, world, device="cpu")))
    poses = _sharded_poses(cam, 2)
    key = prng.PRNGKey(3)
    cfg = RenderConfig(128, 96, backend="cuda")
    shadow = RenderConfig(128, 96, backend="cuda", lighting="lambert_shadow")
    cases = {
        "rows_primary": ("rows", "render_image_sharded", shadow, rows, poses, ()),
        "rows_whitted": ("rows", "render_image_whitted_sharded", cfg, rows, poses, ()),
        "rows_path": ("rows", "render_image_path_traced_sharded", cfg, rows, poses,
                      (key, 2, 2)),
        "shards_primary": ("shards", "render_image_scene_sharded", shadow, chunks, poses, ()),
        "shards_whitted": ("shards", "render_image_whitted_scene_sharded", cfg, chunks, poses,
                           (1,)),
        "shards_path": ("shards", "render_image_path_scene_sharded", cfg, chunks, poses,
                        (key, 2, 2)),
    }
    ranks = spawn(compiled_sharded_rank, world, args=(cases,), device="cuda:0",
                  backend=backend)
    for r, res in enumerate(ranks):
        for name, got in res.items():
            if name.startswith("shards") and backend == "gloo":
                assert isinstance(got, str) and "NCCL" in got, (r, name, got)
                continue
            assert got["same"] == [True, True], (r, name)
            assert got["graph"] and got["entries"] == 1 and got["replays"] == 2, (r, name)
            assert all(el == got["replay"] for el in got["eager_launches"]), (r, name, got)
            assert got["replay"], (r, name)


def test_big_scene_route_launches_k4_alone(cuda, monkeypatch):
    """A scene that needs paging (the rule's rows lowered below the
    small colonnade's 13,320) compiles with page tables only, and the
    ``cuda`` and ``bvh`` backends cast it with K4: one launch a cast,
    bitwise the forced ``paged`` cast and the plain version, any hit
    the nearest hit's answer, frames launching K4 alone."""
    from tpu_raytracer_torch.render import render_image
    from tpu_raytracer_torch.render.renderer import get_cast_fn, occlusion_cast_fn

    monkeypatch.setattr(traversal, "PAGING_ROWS", 64)
    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    assert scene.needs_paging() and scene.wide4 is None and scene.paged.arity == 4
    o, d = _rays(cam, cuda)
    forced = paged.cast_rays_paged_cuda(scene, o, d)
    plain = paged.cast_rays_paged_torch(scene, o, d)
    for backend in ("cuda", "bvh"):
        before = (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K4"])
        hit = get_cast_fn(backend)(scene, o, d)
        occ = occlusion_cast_fn(backend)(scene, o, d)
        assert (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K4"]) == (
            before[0], before[1], before[2] + 2)
        for a, b, c in zip(hit[:3], forced[:3], plain[:3]):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(occ.t < FLT_MAX, forced.t < FLT_MAX)
        p = cam.ray_params(cuda)
        before = (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K4"])
        img = render_image(RenderConfig(128, 96, backend=backend, lighting="lambert_shadow"),
                           scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        assert (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"]) == before[:3]
        assert LAUNCHES["K4"] == before[3] + 2
        want = render_image(RenderConfig(128, 96, backend="paged", lighting="lambert_shadow"),
                            scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        assert torch.equal(img, want)


def _eager_frame(fn):
    """(image, launches) of one eager frame: the kernel launches it made."""
    from tpu_raytracer_torch.render.compiled import launch_counts

    before = launch_counts()
    img = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return img, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("case", ["flagship_flat", "flagship_shadow", "config4_whitted",
                                  "config4_aovs", "config5_path_cuda", "config5_path_bvh",
                                  "routed_k4"])
def test_compiled_frames_replay_the_eager_frames_bitwise(cuda, case, monkeypatch):
    """Each compiled entry point captured once, then replayed at 3 poses:
    every frame bitwise the eager frame at that pose (every AOV), the
    launches of a replay those of the eager frame, one entry. Config 4
    then moves an instance (``update_instance``: its rows and the TLAS)
    and the path frames take a new key, each replayed by the same graph.
    ``routed_k4``: a scene past the paging limit (lowered to 64 rows)
    through ``cuda``, which casts it with K4."""
    from tpu_raytracer_torch.app.scenes import scene_bunny
    from tpu_raytracer_torch.render import pipeline
    from tpu_raytracer_torch.utils import prng

    pipeline.clear_compiled()
    name, extra = "render_image", ()
    if case.startswith("flagship"):
        scene, cam = scene_bunny(256, 144, subdivisions=4, device=cuda)
        config = RenderConfig(256, 144, lighting="flat" if case.endswith("flat")
                              else "lambert_shadow")
    elif case.startswith("config4"):
        scene, cam = scene_instances(256, 256, device=cuda)
        config = RenderConfig(256, 256)
        name = "render_image_whitted" if case.endswith("whitted") else "render_aovs"
    elif case == "routed_k4":
        monkeypatch.setattr(traversal, "PAGING_ROWS", 64)
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
        assert scene.needs_paging()
        config = RenderConfig(128, 96, lighting="lambert_shadow")
    else:
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
        config = RenderConfig(128, 96, backend=case.rsplit("_", 1)[1])
        name, extra = "render_image_path_traced", (prng.PRNGKey(7, device=cuda), 2, 2)
    eager, frame = getattr(pipeline, name), getattr(pipeline, "compiled_" + name)
    start = cam.pose.copy()

    def check(sc, *more):
        p = cam.ray_params(cuda)
        args = (config, sc, p["K_inv"], p["D"], p["pose"], p["inv_pose"], *(more or extra))
        got = frame(*args)
        want, launches = _eager_frame(lambda: eager(*args))
        for g, w in ((got, want),) if name != "render_aovs" else zip(got.values(), want.values()):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        assert frame.last.launches == launches and launches
        assert case != "routed_k4" or launches == {"K4": 2, "S1": 1, "S2": 1, "S3": 1}
        return frame.last

    for step in range(3):
        cam.pose = start + np.float32(0.05 * step) * np.array([1, 1, 0.5, 1, 0.2, 0], np.float32)
        entry = check(scene)
    graph = entry.graph
    assert graph is not None and entry.replays == 3 and len(frame.entries) == 1
    if case.startswith("config4"):
        moved = MeshInstance(int(scene.inst_mesh[0]), int(scene.inst_material[0]))
        moved.pose = np.array([0.3, -0.2, 0.1, 0.5, 0.0, 0.0], np.float32)
        check(scene.update_instance(0, moved))
    if case.startswith("config5"):
        check(scene, prng.PRNGKey(8, device=cuda), 2, 2)
    assert frame.last.graph is graph and len(frame.entries) == 1
    pipeline.clear_compiled()


def _frame_set(which, device):
    """(scene, camera, cast) of a frame-stage set: the flagship mesh (K1,
    untextured), config 4 (K3, textured floor), the textured cube (K1) or
    the demo with its sky map under the reference fisheye calibration
    (K3)."""
    from tpu_raytracer_torch.app.scenes import build_demo_scene, scene_bunny
    from tpu_raytracer_torch.render import reference_calibration

    if which == "flagship":
        scene, cam = scene_bunny(256, 144, subdivisions=4, device=device)
        return scene, cam, traversal.cast_rays_cuda
    if which == "config4":
        scene, cam = scene_instances(256, 192, device=device)
        return scene, cam, tlas.cast_rays_tlas_cuda
    if which == "cube":
        scene, cam = scene_cube(128, device=device)
        return scene, cam, traversal.cast_rays_cuda
    K, D = reference_calibration(192, 108)
    cam = Camera(192, 108, K, D, pose=np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32))
    demo = build_demo_scene()
    demo.set_sky(procgen.sky_gradient_texture())
    return demo.compile(device), cam, tlas.cast_rays_tlas_cuda


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same_bits(x, y) for x, y in zip(a, b, strict=True))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("which", ["flagship", "config4", "cube", "fisheye_demo"])
def test_frame_kernels_match_plain_versions_bitwise(cuda, which, exact):
    """S1, S2 (the carried and the redo hit records, both normal modes) and
    S3 (every mode, the three texture filters, point lights with and
    without the directional light) against their plain versions, every
    field bit for bit, misses included; one launch each per call."""
    from tpu_raytracer_torch.kernels import frame
    from tpu_raytracer_torch.render.camera import generate_rays_torch
    from tpu_raytracer_torch.render.integrators import PointLight
    from tpu_raytracer_torch.render.renderer import hit_attributes_torch
    from tpu_raytracer_torch.render.shade import shade_primary, shade_primary_torch

    scene, cam, cast = _frame_set(which, cuda)
    p = cam.ray_params(cuda)
    args = (cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"], exact)
    before = LAUNCHES["S1"]
    o, d = generate_rays(*args)
    assert LAUNCHES["S1"] == before + 1
    assert _same_bits((o, d), generate_rays_torch(*args))
    attrs = None
    for h in (cast(scene, o, d, want_normals=True), cast(scene, o, d, carry=False)):
        # config 4's primary rays hit everywhere; its reflection rays miss
        # (test_frame_kernels_take_per_ray_origins)
        assert (h.tri < 0).any() or which == "config4"
        for normal_mode in ("reference", "inverse_transpose"):
            before = LAUNCHES["S2"]
            got = hit_attributes(scene, o, d, h, exact, normal_mode)
            assert LAUNCHES["S2"] == before + 1 and got.t is h.t
            assert _same_bits(tuple(got), tuple(hit_attributes_torch(scene, o, d, h, exact,
                                                                     normal_mode)))
            attrs = attrs or got
    lights = (PointLight((0.0, 2.0, 2.0), 4.0), PointLight((1.5, -1.0, 2.5), 6.0))
    configs = [(m, DEFAULT_LIGHT_DIRECTION, f, ()) for m in frame.MODES
               for f in ("nearest", "trilinear")]
    configs += [(m, DEFAULT_LIGHT_DIRECTION, "bilinear", lights) for m in frame.MODES]
    configs += [("lambert_shadow", None, "nearest", lights)]
    for mode, light, filt, pls in configs:
        kw = dict(directions=d, point_lights=pls, tex_filter=filt)
        before = LAUNCHES["S3"]
        got = shade_primary(scene, attrs, light, mode, exact, **kw)
        assert LAUNCHES["S3"] == before + 1
        want = shade_primary_torch(scene, attrs, light, mode, exact, **kw)
        assert torch.equal(got, want), (mode, light, filt, len(pls))
    if which == "fisheye_demo":  # the sky map, not the flat colour, on the misses
        assert not (got[~attrs.hit] == torch.tensor(SKY_COLOR, device=cuda)).all(-1).any()


def test_frame_kernels_take_per_ray_origins(cuda):
    """S2 on config 4's reflection rays (an origin per ray, parked dead
    rays among them), carried and redone."""
    from tpu_raytracer_torch.render.renderer import hit_attributes_torch

    scene, cam, cast = _frame_set("config4", cuda)
    o, d = _rays(cam, cuda)
    a = hit_attributes(scene, o, d, cast(scene, o, d, want_normals=True))
    rd = normalize(_reflect(d, a.normal))
    ro, rd = park_dead_rays(a.location + rd * SHADOW_EPS, rd, a.hit)
    for h in (cast(scene, ro, rd, want_normals=True), cast(scene, ro, rd, carry=False)):
        assert (h.tri < 0).any() and (h.tri >= 0).any()
        assert _same_bits(tuple(hit_attributes(scene, ro, rd, h)),
                          tuple(hit_attributes_torch(scene, ro, rd, h)))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("which", ["config4", "sky_demo"])
def test_whitted_shade_kernel_matches_plain_version_bitwise(cuda, which, exact):
    """S5 against ``whitted_shade_torch`` on each bounce of a 1920x1088
    Whitted frame, config 4's (flat sky, nearest texels) and the demo's
    under its sky map (trilinear, sampled bilinear; its materials made
    mirrors): the state and the next rays bit for bit, misses and parked
    rays included, one launch a call."""
    import dataclasses

    from tpu_raytracer_torch.render.integrators import (
        _direct_illumination, whitted_shade, whitted_shade_torch,
    )

    if which == "config4":
        scene, cam = scene_instances(1920, 1088, device=cuda)
        filt = "nearest"
    else:
        scene, cam, _ = _frame_set("fisheye_demo", cuda)
        k = scene.mat_albedo.shape[0]
        scene = dataclasses.replace(scene, mat_reflectivity=torch.tensor(
            [(0.8, 0.5, 0.0)[i % 3] for i in range(k)], device=cuda))
        filt = "trilinear"
    p = cam.ray_params(cuda)
    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
                         exact=exact)
    state, misses = None, 0
    for bounce in range(3):
        h = tlas.cast_rays_tlas_cuda(scene, o, d, want_normals=True)
        attrs = hit_attributes(scene, o, d, h, exact)
        illum = _direct_illumination(scene, tlas.cast_rays_tlas_cuda, attrs,
                                     DEFAULT_LIGHT_DIRECTION, (), exact, True, clamp_floor=0.4)
        last = bounce == 2
        want = whitted_shade_torch(scene, d, attrs, illum, state, exact, filt, last)
        before = LAUNCHES["S5"]
        mine = None if state is None else tuple(x.clone() for x in state)
        got = whitted_shade(scene, d, attrs, illum, mine, exact, filt, last)
        assert LAUNCHES["S5"] == before + 1
        assert _same_bits(got[0], want[0]), bounce
        assert (got[1] is None) == last and (last or _same_bits(got[1], want[1])), bounce
        state, misses = want[0], misses + int((~attrs.hit).sum())
        if not last:
            o, d = want[1]
        assert bounce or (state[2].any() and (~state[2]).any())  # mirrors among the hits
    assert misses > 0  # config 4's primary rays hit everywhere, its reflection rays miss


def test_compiled_whitted_entry_shades_with_s5(cuda, monkeypatch):
    """The compiled config 4 Whitted frame at 1920x1088: a replay launches
    K3 six times (three carrying), S1 once, S2 and S5 three times, and
    equals the eager frame and the frame through the plain shade."""
    from tpu_raytracer_torch.render import integrators, pipeline

    pipeline.clear_compiled()
    scene, cam = scene_instances(1920, 1088, device=cuda)
    p = cam.ray_params(cuda)
    args = (RenderConfig(1920, 1088), scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    img = pipeline.compiled_render_image_whitted(*args)
    entry = pipeline.compiled_render_image_whitted.last
    assert entry.launches == {"K3": 6, "K3_carry": 3, "S1": 1, "S2": 3, "S5": 3}
    assert torch.equal(img, pipeline.render_image_whitted(*args))
    with monkeypatch.context() as m:
        m.setattr(integrators, "whitted_shade", integrators.whitted_shade_torch)
        assert torch.equal(img, pipeline.render_image_whitted(*args))
    pipeline.clear_compiled()


def _path_scene(which, device):
    """(scene, camera, texture filter) of an S6 set: config 5's small
    colonnade (one albedo, the flat sky), or config 4 with its materials'
    reflectivity 0.7, 0.35 and 0 in turn, roughness 0, 0.3 and 1 in turn
    and material 1 emissive (its textured floor among them)."""
    import dataclasses

    if which == "config5":
        scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=device)
        return scene, cam, "nearest"
    scene, cam = scene_instances(256, 192, device=device)
    k = scene.mat_albedo.shape[0]
    table = lambda vals: torch.tensor([vals[i % len(vals)] for i in range(k)], device=device)
    scene = dataclasses.replace(
        scene, mat_reflectivity=table((0.7, 0.35, 0.0)), mat_roughness=table((0.0, 0.3, 1.0)),
        mat_illumination=torch.tensor([0.25 if i == 1 else 0.0 for i in range(k)], device=device))
    return scene, cam, "bilinear"


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("which", ["config5", "config4"])
def test_path_bounce_kernel_matches_plain_version_bitwise(cuda, which, exact):
    """S6 against ``path_bounce_torch`` (eager ops on the card) on the
    bounces of a batched 2-sample path frame: the first on the primary rows
    expanded over the samples, the second per ray, then the fast tail on
    the any-hit cast, or with NEE's light term a third full bounce; the
    state and the next rays bit for bit, misses and parked rays included,
    one launch a call. Both sides draw with S4."""
    import math

    from tpu_raytracer_torch.render.integrators import (
        _direct_illumination, path_bounce, path_bounce_torch,
    )
    from tpu_raytracer_torch.render.renderer import get_cast_fn, occlusion_cast_fn
    from tpu_raytracer_torch.utils import prng

    scene, cam, filt = _path_scene(which, cuda)
    cast, occ = get_cast_fn("cuda", want_normals=True), occlusion_cast_fn("cuda")
    o, d = _rays(cam, cuda)
    bc = lambda x: x[None].expand((2,) + x.shape)
    attrs0 = hit_attributes(scene, o, d, cast(scene, o, d), exact)
    key = prng.PRNGKey(2 ** 40 + 29, device=cuda)
    shading = dict(exact=exact, tex_filter=filt, sky_strength=1.5,
                   light_scale=(1.0 / math.pi) * 2.0)
    for nee in (False, True):
        state, rd, attrs, parked = None, bc(d), type(attrs0)(*map(bc, attrs0)), 0
        for b in range(3):
            tail = b == 2 and not nee
            illum = None
            if nee:
                illum = _direct_illumination(scene, cast, attrs, DEFAULT_LIGHT_DIRECTION, (),
                                             exact, True, occ_cast=occ, shadow_floor=0.0)
            if tail:
                attrs = occ(scene, ro, rd)
            args = (scene, rd, attrs, state, key, (b,), illum)
            want = path_bounce_torch(*args, tail=tail, **shading)
            mine = None if state is None else tuple(x.clone() for x in state)
            before = LAUNCHES["S6"]
            got = path_bounce(*args[:3], mine, *args[4:], tail=tail, **shading)
            assert LAUNCHES["S6"] == before + 1
            assert _same_bits(got[0], want[0]), (nee, b)
            assert (got[1] is None) == tail and (tail or _same_bits(got[1], want[1])), (nee, b)
            state, parked = want[0], int((~want[0][2]).sum())
            if not tail:
                ro, rd = want[1]
                attrs = hit_attributes(scene, ro, rd, cast(scene, ro, rd), exact)
        assert 0 < parked < state[2].numel()


@pytest.mark.parametrize("path_lights", [False, True])
def test_compiled_path_entry_bounces_with_s6(cuda, path_lights, monkeypatch):
    """The compiled config 5 path frame (2 samples, 2 bounces): a replay
    launches S4 twice and S6 three times (two bounces and the fast tail; with
    NEE's lights three draws and three bounces), and every replay equals
    the eager frame and the frame through the plain stages, bit for bit; the
    64x64 frame keeps within its golden's pixels."""
    import importlib

    from tpu_raytracer_torch.kernels import frame
    from tpu_raytracer_torch.render import camera, integrators, pipeline, renderer, shade
    from tpu_raytracer_torch.utils import prng

    plain = {"generate_rays": camera.generate_rays_torch,
             "hit_attributes": renderer.hit_attributes_torch,
             "shade_primary": shade.shade_primary_torch,
             "sample_cosine": integrators.sample_cosine_torch,
             "whitted_shade": integrators.whitted_shade_torch,
             "path_bounce": integrators.path_bounce_torch}
    pipeline.clear_compiled()
    for size in (128, 64):
        scene, cam = scene_colonnade(size, 96 if size == 128 else 64, columns=4, segs=8,
                                     device=cuda)
        config = RenderConfig(cam.width, cam.height, path_lights=path_lights)
        p = cam.ray_params(cuda)
        frames = []
        for seed in (7, 8):
            args = (config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
                    prng.PRNGKey(seed, device=cuda), 2, 2)
            frames.append((pipeline.compiled_render_image_path_traced(*args), args))
        entry = pipeline.compiled_render_image_path_traced.last
        want = {"S4": 3, "S6": 3} if path_lights else {"S4": 2, "S6": 3}
        assert {k: entry.launches.get(k) for k in want} == want and entry.replays == 2
        for img, args in frames:
            assert torch.equal(img, pipeline.render_image_path_traced(*args))
            with monkeypatch.context() as m:
                for mod in map(importlib.import_module, (f"tpu_raytracer_torch.{x}"
                                                         for x in frame.ROUTER_MODULES)):
                    for name, fn in plain.items():
                        if hasattr(mod, name):
                            m.setattr(mod, name, fn)
                assert torch.equal(img, pipeline.render_image_path_traced(*args))
        if size == 64 and not path_lights:
            golden = np.load(os.path.join(GOLDEN_DIR, "config5_colonnade_path_64.npy"))
            assert (frames[0][0].cpu().numpy() != golden).any(-1).sum() <= 16
        pipeline.clear_compiled()


def test_compiled_path_entry_casts_bounces_unsorted(cuda):
    """The compiled config 5 path frame with its defaults casts its bounce
    rays and any-hit tail in wavefront order: its image is bitwise the
    entry's with ``sort_secondary=True``, its graph holds fewer nodes, a
    profiled replay runs no radix sort and no scatter (the sorted entry's
    runs both) and fewer gathers (those left are each K1 launch's lookup
    of the instance roots), and both replays launch the same kernels."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_raytracer_torch.render import pipeline
    from tpu_raytracer_torch.utils import prng

    pipeline.clear_compiled()
    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    p = cam.ray_params(cuda)
    args = (RenderConfig(128, 96), scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
            prng.PRNGKey(7, device=cuda), 2, 2)
    frame = pipeline.compiled_render_image_path_traced
    entries, kernels = {}, {}
    for sort in (False, True):
        kw = {"sort_secondary": True} if sort else {}
        img = frame(*args, **kw)
        entries[sort] = (frame.last, img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            frame(*args, **kw)
            torch.cuda.synchronize()
        kernels[sort] = {e.key: e.count for e in prof.key_averages()}
    (plain, img), (sorted_, want) = entries[False], entries[True]
    assert plain is not sorted_ and torch.equal(img, want)
    assert plain.nodes < sorted_.nodes
    launches = {"K1": 3, "K1_carry": 2, "S1": 1, "S2": 2, "S4": 2, "S6": 3}
    assert plain.launches == launches and sorted_.launches == launches

    def launched(sort, pattern):
        return sum(n for k, n in kernels[sort].items() if pattern in k)

    assert launched(False, "wide_traverse") == launched(True, "wide_traverse") == 3
    for pattern in ("RadixSort", "index_put_kernel_impl"):
        assert launched(False, pattern) == 0 < launched(True, pattern), pattern
    assert launched(False, "index_kernel_impl") < launched(True, "index_kernel_impl")
    pipeline.clear_compiled()


@pytest.mark.parametrize("lighting", ["flat", "lambert_shadow"])
def test_flagship_replay_launches_each_stage_once(cuda, lighting, monkeypatch):
    """The compiled flagship frame: a replay launches S1, S2 and S3 once
    each, no CUDA tensor reaches a plain stage, a replay at a new pose
    equals the eager frame at that pose (the camera is read through
    device pointers) and the frame through the plain stages."""
    import importlib

    from tpu_raytracer_torch.app.scenes import scene_bunny
    from tpu_raytracer_torch.kernels import frame
    from tpu_raytracer_torch.render import camera, pipeline, renderer, shade

    pipeline.clear_compiled()
    scene, cam = scene_bunny(256, 144, subdivisions=4, device=cuda)
    config = RenderConfig(256, 144, lighting=lighting)
    frames, start = [], cam.pose.copy()
    for step in range(3):
        cam.pose = start + np.float32(step) * np.array([0.05, -0.05, 0.02, 0.03, 0, 0],
                                                       np.float32)
        p = cam.ray_params(cuda)
        args = (config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        frames.append((pipeline.compiled_render_image(*args), args))
    entry = pipeline.compiled_render_image.last
    assert {k: entry.launches.get(k) for k in ("S1", "S2", "S3")} == {"S1": 1, "S2": 1, "S3": 1}
    assert entry.replays == 3 and len(pipeline.compiled_render_image.entries) == 1
    assert not torch.equal(frames[0][0], frames[2][0])
    plain = {"generate_rays": camera.generate_rays_torch,
             "hit_attributes": renderer.hit_attributes_torch,
             "shade_primary": shade.shade_primary_torch}
    for img, args in frames:
        with monkeypatch.context() as m:
            for mod, name in ((camera, "generate_rays_torch"),
                              (renderer, "hit_attributes_torch"), (shade, "shade_primary_torch")):
                m.setattr(mod, name, _refuse_cuda(getattr(mod, name)))
            assert torch.equal(img, pipeline.render_image(*args))
        with monkeypatch.context() as m:
            for mod in map(importlib.import_module, (f"tpu_raytracer_torch.{x}"
                                                     for x in frame.ROUTER_MODULES)):
                for name, fn in plain.items():
                    if hasattr(mod, name):
                        m.setattr(mod, name, fn)
            assert torch.equal(img, pipeline.render_image(*args))
    pipeline.clear_compiled()


def _refuse_cuda(fn):
    def guarded(*args, **kwargs):
        tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
        assert not any(t.is_cuda for t in tensors), f"a CUDA tensor reached {fn.__name__}"
        return fn(*args, **kwargs)

    return guarded


def _sample_sites(device):
    """(key, {call site: (normals, chain, lobe)}) of S4's draws on a
    small colonnade frame with misses: AO's, the batched path tracer's
    bounce 0 (the normals expanded over 2 samples, stride 0) and bounce 1
    (a contiguous batch), the sequential one's chain of two words."""
    from tpu_raytracer_torch.utils import prng

    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=device)
    o, d = _rays(cam, device)
    h = traversal.cast_rays_cuda(scene, o, d, want_normals=True)
    assert (h.tri < 0).any() and (h.tri >= 0).any()
    n = hit_attributes(scene, o, d, h).normal
    batch = n[None].expand((2,) + n.shape)
    assert batch.stride(0) == 0
    return prng.PRNGKey(2 ** 40 + 12345, device=device), {
        "ao": [(n, (s,), False) for s in (0, 7)],
        "path": [(batch, (0,), True), (batch.contiguous(), (1,), True), (n, (1, 2), True)]}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("site", ["ao", "path"])
def test_sample_kernel_matches_plain_chain_bitwise(cuda, site, exact):
    """S4 against its plain chain on the card (``utils/prng.py``'s eager
    threefry ops and ``_cosine_sample``): directions and lobe uniforms bit
    for bit, one launch a draw."""
    from tpu_raytracer_torch.render.integrators import sample_cosine, sample_cosine_torch

    key, sites = _sample_sites(cuda)
    for n, chain, lobe in sites[site]:
        before = LAUNCHES["S4"]
        got = sample_cosine(key, chain, n, exact, lobe)
        assert LAUNCHES["S4"] == before + 1
        want = sample_cosine_torch(key, chain, n, exact, lobe)
        if not lobe:
            got, want = (got,), (want,)
        assert got[0].shape == n.shape and _same_bits(got, want), (chain, lobe)


@pytest.mark.parametrize("kind", ["ao", "path"])
def test_compiled_sample_stage_is_s4_alone(cuda, kind, monkeypatch):
    """The compiled AO and path frames draw through S4 alone: one launch a
    draw in a replay (8 AO samples, 2 path bounces before the any-hit
    tail), no threefry op on a CUDA tensor, every replay bitwise the eager
    frame and the frame through the plain chain."""
    from tpu_raytracer_torch.render import integrators, pipeline
    from tpu_raytracer_torch.utils import prng

    pipeline.clear_compiled()
    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    config = RenderConfig(128, 96)
    name, extra = (("render_image_ao", (8, 1.0)) if kind == "ao"
                   else ("render_image_path_traced", (2, 2)))
    eager, compiled = getattr(pipeline, name), getattr(pipeline, "compiled_" + name)
    p = cam.ray_params(cuda)
    frames = []
    with monkeypatch.context() as m:
        m.setattr(prng, "threefry2x32", _refuse_cuda(prng.threefry2x32))
        for seed in (7, 8):
            args = (config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
                    prng.PRNGKey(seed, device=cuda), *extra)
            frames.append((compiled(*args), args))
    entry = compiled.last
    assert entry.launches.get("S4") == (8 if kind == "ao" else 2) and entry.replays == 2
    assert not torch.equal(frames[0][0], frames[1][0])
    for img, args in frames:
        assert torch.equal(img, eager(*args))
        with monkeypatch.context() as m:
            m.setattr(integrators, "sample_cosine", integrators.sample_cosine_torch)
            assert torch.equal(img, eager(*args))
    pipeline.clear_compiled()


def _ao_sample_rays(device):
    """(scene, origins, directions) of AO's first sample rays on a small
    colonnade, dead rays parked, as ``render_ao`` casts them."""
    from tpu_raytracer_torch.render.integrators import sample_cosine
    from tpu_raytracer_torch.utils import prng

    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=device)
    o, d = _rays(cam, device)
    attrs = hit_attributes(scene, o, d, traversal.cast_rays_cuda(scene, o, d, want_normals=True))
    nd = sample_cosine(prng.PRNGKey(2147500301, device=device), (0,), attrs.normal)
    return (scene, *park_dead_rays(attrs.location + nd * SHADOW_EPS, nd, attrs.hit))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_bounded_walks_match_plain_versions_bitwise(cuda, kernel):
    """K1 and K2 bounded by AO's radius (1.0) equal their plain versions
    bit for bit on AO's sample rays (t, tri, inst), which hold hits within
    the radius and hits beyond it that the bound turns into misses; K1
    counts the launch as bounded."""
    scene, o, d = _ao_sample_rays(cuda)
    if kernel == "K1":
        cast, plain = traversal.cast_rays_cuda, traversal.cast_rays_wide_torch
    else:
        cast, plain = binary.cast_rays_binary_cuda, binary.cast_rays_binary_torch
    before = LAUNCHES["K1_bounded"]
    got = cast(scene, o, d, t_max=1.0)
    torch.cuda.synchronize()
    assert LAUNCHES["K1_bounded"] == before + (kernel == "K1")
    want = plain(scene, o, d, t_max=1.0)
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    assert torch.equal(got.tri, want.tri) and torch.equal(got.inst, want.inst)
    far = cast(scene, o, d).t
    assert (got.tri >= 0).any() and ((far >= 1.0) & (far < FLT_MAX)).any()
    assert torch.equal(got.t < 1.0, far < 1.0)


@pytest.mark.parametrize("kind", ["ao", "path"])
def test_compiled_frames_count_bounded_casts(cuda, kind):
    """A compiled AO replay on a one-instance scene launches K1 nine
    times: the carrying primary cast and 8 sample casts bounded by the
    radius; a path replay launches no bounded cast."""
    from tpu_raytracer_torch.render import pipeline
    from tpu_raytracer_torch.utils import prng

    pipeline.clear_compiled()
    scene, cam = scene_colonnade(128, 96, columns=4, segs=8, device=cuda)
    name, extra = (("render_image_ao", (8, 1.0)) if kind == "ao"
                   else ("render_image_path_traced", (2, 2)))
    p = cam.ray_params(cuda)
    frame = getattr(pipeline, "compiled_" + name)
    frame(RenderConfig(128, 96), scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
          prng.PRNGKey(7, device=cuda), *extra)
    launches = frame.last.launches
    if kind == "ao":
        assert (launches.get("K1"), launches.get("K1_carry"), launches.get("K1_bounded")) \
            == (9, 1, 8)
    else:
        assert launches.get("K1") == 3 and "K1_bounded" not in launches
    pipeline.clear_compiled()
