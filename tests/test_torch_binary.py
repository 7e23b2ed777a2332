"""Kernel K2 (the binary BVH walk, the port's ``bvh`` backend) on the CPU,
against the JAX package's binary walks.

The host build of K2's own traversal code (``csrc/traverse_host.cpp``
over ``csrc/walk.cuh`` at arity 2, g++ -ffp-contract=off) must equal the
plain version bit for bit, in both modes, at the default short stack and
at one ring slot. Against the JAX package, on the JAX package's own scenes and rays:

  * ``_traversal_kernel`` in interpret mode (``TRT_DUAL=0``, as
    tests/test_wide4.py runs it): tri and inst equal, t within rtol 2e-6
    and atol 1e-6 (interpret mode contracts FMAs, as
    tests/test_torch_cast.py notes: 1.45e-6 relative, 6.7e-6 absolute at
    most on the two-instance scene);
  * ``cast_rays_bvh``: tri and inst equal, every ray hits or misses
    alike, t within rtol 4e-6 (the jitted XLA walk contracts FMAs in
    ``ray_plane_hit``: up to 31 ulps, 2.5e-6 relative, measured on
    blob-3); against the eager JAX brute cast, which rounds every op as
    the port does, t is bit-exact, and every tri/inst difference is one
    that ``traversal.unexplained_differences`` explains.

The goldens of configs 1-4 (JAX ``bvh`` renders) match exactly through
``backend="bvh"``, and so do the demo's two rays that graze the cube's
edge, which the 4-wide tables of K1 cull (ROADMAP Queue 3).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from tpu_raytracer.kernels.traversal import cast_rays_pallas
from tpu_raytracer.render.renderer import cast_rays_brute as jax_brute
from tpu_raytracer.render.renderer import cast_rays_bvh as jax_bvh
from tpu_raytracer_torch.kernels import binary, build, traversal
from tpu_raytracer_torch.kernels.traversal import BIG, child_entry
from tpu_raytracer_torch.render import Hit, RenderConfig, render_image, render_image_whitted
from tpu_raytracer_torch.render.renderer import cast_rays_bvh, get_cast_fn, occlusion_cast_fn
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_torch_cast import TINY_STACK, host_trace, host_trace_spills, port_rays, port_scene
from test_torch_scene import compiled, jax_fields, jax_rays

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SCENES = ("cube", "two_instance", "blob3")


def as_port_hit(h) -> Hit:
    return Hit(*(torch.from_numpy(np.array(x)) for x in h[:3]))


def t_bits(t) -> np.ndarray:
    return np.asarray(t).reshape(-1).view(np.int32)


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_header_host_build_matches_plain_version(name, occlusion):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene = port_scene(name)
    o, d = port_rays(name)
    want = binary.cast_rays_binary_torch(scene, o, d, occlusion=occlusion)
    t, tri, inst = host_trace(scene, o, d, occlusion=occlusion, arity=2)
    np.testing.assert_array_equal(t_bits(t), t_bits(want.t))
    if not occlusion:  # an any-hit record's tri/inst carry no meaning
        np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
        np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())
    if occlusion:  # any-hit answers: the nearest cast's hit or miss
        near = binary.cast_rays_binary_torch(scene, o, d)
        assert torch.equal(want.t < 0, near.t < 3.0e38) and (want.t < 0).any()


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_host_build_with_tiny_short_stack_matches_plain_version(name, occlusion):
    """K2's walk with its short stack cut to 1 ring slot, so that entries
    go through the spill path, equals the plain version bit for bit
    (any hit: its t, and the nearest cast's answers); the spill count
    shows the path was taken on every scene but the cube, whose one leaf
    is the whole tree."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    scene = port_scene(name)
    o, d = port_rays(name)
    want = binary.cast_rays_binary_torch(scene, o, d, occlusion=occlusion)
    t, tri, inst, spills = host_trace_spills(scene, o, d, occlusion, arity=2,
                                             short_stack=TINY_STACK)
    np.testing.assert_array_equal(t_bits(t), t_bits(want.t))
    if occlusion:
        near = binary.cast_rays_binary_torch(scene, o, d)
        assert torch.equal(t < 0, near.t.reshape(-1) < 3.0e38)
    else:
        np.testing.assert_array_equal(tri.numpy(), want.tri.reshape(-1).numpy())
        np.testing.assert_array_equal(inst.numpy(), want.inst.reshape(-1).numpy())
    assert (spills > 0) == (name != "cube")
    assert host_trace_spills(scene, o, d, occlusion, arity=2)[3] < max(spills, 1)


def test_binary_records_unpack_to_code_and_box():
    """Lane for lane, K2's node records hold the binary tables' 12 box
    floats, the 2 child codes' bits in lanes 12..13 and zeros in 14..15,
    bit for bit, the cube's entered leaf-root box included; they follow
    the scene to another device, and the host build casts the cube's
    axis-aligned rays through that box as the plain version does."""
    for name in SCENES:
        tree = port_scene(name).binary
        rec = tree.node.numpy()
        assert rec.shape == (tree.code.shape[0], 16) and rec.dtype == np.float32
        np.testing.assert_array_equal(rec[:, :12].view(np.int32), tree.box.numpy().view(np.int32))
        np.testing.assert_array_equal(rec[:, 12:14].view(np.int32), tree.code.numpy())
        assert not rec[:, 14:].view(np.int32).any()
        assert torch.equal(tree.to("cpu").node.view(torch.int32), tree.node.view(torch.int32))
    scene = port_scene("cube")
    np.testing.assert_array_equal(scene.binary.node[0, :6].numpy(),
                                  np.float32([-BIG] * 3 + [BIG] * 3))
    if shutil.which("g++") is None:
        return
    d = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0], [-1.0, -1.0, -1.0], [0, 1.0, 0]])
    o = torch.tensor([[-5.0, 0.2, 0.1], [0.3, 5.0, -0.2], [0.1, 0.1, -9.0], [4.0, 4.0, 4.0],
                      [0.0, -3.0, 0.0]])
    want = binary.cast_rays_binary_torch(scene, o, d)
    assert (want.tri >= 0).all()
    t, tri, inst = host_trace(scene, o, d, arity=2)
    np.testing.assert_array_equal(t_bits(t), t_bits(want.t))
    np.testing.assert_array_equal(tri.numpy(), want.tri.numpy())


@pytest.mark.parametrize("name", ["cube", "two_instance"])
def test_plain_version_matches_jax_binary_kernel(name, monkeypatch):
    monkeypatch.setenv("TRT_DUAL", "0")  # the binary kernel, not the wide one
    monkeypatch.setenv("TRT_TLAS", "0")
    ja, _ = compiled(name, "jax")
    o, d = jax_rays(name)
    assert d.shape[0] * d.shape[1] <= 4096
    want = cast_rays_pallas(ja, o, d, interpret=True)
    got = binary.cast_rays_binary_torch(port_scene(name), *port_rays(name))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(want.inst))
    assert (got.tri >= 0).float().mean() > 0.1


@pytest.mark.parametrize("name", SCENES)
def test_plain_version_matches_jax_bvh_and_brute(name):
    ja, _ = compiled(name, "jax")
    o, d = jax_rays(name)
    scene = port_scene(name)
    po, pd = port_rays(name)
    got = binary.cast_rays_binary_torch(scene, po, pd)
    walk = jax_bvh(ja, o, d)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(walk.tri))
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(walk.inst))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(walk.t), rtol=4e-6, atol=0)
    differ = int((t_bits(got.t) != t_bits(walk.t)).sum())
    print(f"{name}: t differs from the jitted JAX bvh walk (FMA) on {differ} rays")
    brute = jax_brute(ja, o, d)
    np.testing.assert_array_equal(t_bits(got.t), t_bits(brute.t))
    assert traversal.unexplained_differences(scene, po, pd, got, as_port_hit(brute)) == 0


def _demo_after_two_spins():
    """The JAX demo scene after the driver's two spins, and its 64x64
    camera (tests/test_torch_whitted.py::test_driver_renders_the_demo)."""
    from tpu_raytracer.app.driver import build_demo_scene
    from tpu_raytracer.render import Camera as JaxCamera
    from tpu_raytracer.scene import MeshInstance as JaxMeshInstance

    arrays = build_demo_scene().compile()
    for angle in (0.005, 0.010):
        spun = JaxMeshInstance(0, 2)
        spun.pose = np.array([0, 0, 0, angle, 0, 0], np.float32)
        arrays = arrays.update_instance(0, spun)
    cam = JaxCamera.looking(64, 64, fov_deg=60.0)
    cam.pose = np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32)
    p = cam.ray_params()
    return arrays, (p["K_inv"], p["D"], p["pose"], p["inv_pose"])


def test_demo_grazing_rays_match_jax_bvh():
    """The demo's cube is a single-leaf mesh: the JAX ``bvh`` walk tests
    no box of it, K1's 4-wide tables test its root box and cull the two
    rays that graze its edge (ROADMAP Queue 3). K2's entry for that root
    is entered by every ray, so its image is the JAX ``bvh`` image."""
    from tpu_raytracer.render import RenderConfig as JaxConfig
    from tpu_raytracer.render import render_image as jax_render

    arrays, jargs = _demo_after_two_spins()
    want = np.asarray(jax_render(JaxConfig(64, 64, backend="bvh"), arrays, *jargs))
    scene = from_scene_arrays(jax_fields(arrays), device="cpu")
    args = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    got = render_image(RenderConfig(64, 64, backend="bvh"), scene, *args).numpy()
    np.testing.assert_array_equal(got, want)
    k1 = render_image(RenderConfig(64, 64, backend="cuda"), scene, *args).numpy()
    assert (k1 != want).any(-1).sum() == 2


def test_leaf_root_entry_is_entered_by_every_ray_without_nan():
    scene = port_scene("cube")  # one 12-triangle leaf: the mesh root
    tree = scene.binary
    assert tree.code.shape == (1, 2) and tree.depth == 1
    assert int(tree.code[0, 0]) < -1 and int(tree.code[0, 1]) == -1
    np.testing.assert_array_equal(tree.box[0, :6].numpy(),
                                  np.float32([-BIG] * 3 + [BIG] * 3))
    # rays along the axes (zero direction components) and away from it
    d = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0], [-1.0, -1.0, -1.0]])
    o = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0], [-1e9, 3.0, 0.0], [1e9, 1e9, 1e9]])
    from tpu_raytracer_torch.render.intersect import safe_reciprocal

    dist = child_entry(tree.box[0, :6].expand(4, 6), o, safe_reciprocal(d),
                       torch.full((4,), BIG))
    assert not torch.isnan(dist).any() and (dist < BIG).all()
    # the 4-wide tables keep the root's own box (K1's grazing culls)
    assert (scene.wide4.wbox[0, :6].abs() < 10).all()


def test_backend_routes_and_tables_follow_the_scene():
    scene = port_scene("two_instance")
    o, d = port_rays("two_instance")
    assert get_cast_fn("bvh") is cast_rays_bvh  # K2 below the paging rule
    before = dict(build.LAUNCHES)
    got = get_cast_fn("bvh")(scene, o, d)
    assert build.LAUNCHES == before  # CPU tensors run the plain version
    want = binary.cast_rays_binary_torch(scene, o, d)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    occ = occlusion_cast_fn("bvh")(scene, o, d)
    assert torch.equal(occ.t < 0, want.t < 3.0e38)
    assert torch.equal(occ.t >= 3.0e38, want.t >= 3.0e38)
    moved = scene.to("cpu")
    assert torch.equal(moved.binary.box, scene.binary.box)
    from tpu_raytracer_torch.scene import MeshInstance

    posed = scene.update_instance(1, MeshInstance(1, 0))
    assert posed.binary is scene.binary
    with pytest.raises(ValueError, match="binary"):
        binary.cast_rays_binary_torch(dataclasses.replace(scene, binary=None), o, d)
    _, counters = binary.cast_rays_binary_torch(scene, o, d, stats=True)
    _, k1_counters = traversal.cast_rays_wide_torch(scene, o, d, stats=True)
    assert counters["pops"].sum() > k1_counters["pops"].sum()  # two boxes a pop, not four
    assert counters["tests"].sum() > 0


def _config(name):
    from tpu_raytracer_torch.app import scenes

    if name == "config1_cube_64":
        scene, cam = scenes.scene_cube(64, device="cpu")
        return render_image, RenderConfig(64, 64, backend="bvh"), scene, cam
    if name == "config2_cornell_64":
        scene, cam = scenes.scene_cornell(64, device="cpu")
        return render_image, RenderConfig(64, 64, backend="bvh",
                                          lighting="lambert_shadow"), scene, cam
    if name == "config3_bunny_96":
        scene, cam = scenes.scene_bunny(96, 96, subdivisions=4, device="cpu")
        return render_image, RenderConfig(96, 96, backend="bvh",
                                          lighting="blinn_phong"), scene, cam
    scene, cam = scenes.scene_instances(64, 64, device="cpu")
    return render_image_whitted, RenderConfig(64, 64, backend="bvh"), scene, cam


@pytest.mark.parametrize("golden", ["config1_cube_64", "config2_cornell_64",
                                    "config3_bunny_96", "config4_instances_whitted_64"])
def test_goldens_through_bvh_backend(golden):
    fn, config, scene, cam = _config(golden)
    p = cam.ray_params(device="cpu")
    img = fn(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    np.testing.assert_array_equal(img.numpy(), np.load(os.path.join(GOLDEN_DIR, golden + ".npy")))
