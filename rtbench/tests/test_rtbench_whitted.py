"""The ``instances.whitted_1080p`` cell (BASELINE config 4): its frozen
meshes and texture are the port's, its description is ``scene_instances``,
its tiny cell runs correct, the plain Whitted reference agrees with the
port's CPU frames with every pixel that differs put down to a cause, and a
fault planted in the timed path (the mirror's reflectivity ignored, every
shadow ray answered occluded) turns ``correct`` false.

Two faults are not planted, because this scene cannot show them, and a
test holds each fact instead. "One bounce fewer": the scene's only mirror
is one convex sphere, so a reflected ray never meets a mirror again, the
third cast runs on parked rays alone, and a frame at ``max_bounces`` 1
equals one at 2. "Shadows off": no shadow falls where the camera sees it
(``test_shadows_off_changes_no_pixel_of_this_scene``)."""

import json
import os
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from rtbench import check, pose, reference, reference_whitted, scenes, system
from rtbench.generators import instances
from tpu_raytracer_torch.app.scenes import scene_instances
from tpu_raytracer_torch.render import RenderConfig, pipeline
from tpu_raytracer_torch.scene import MeshPrimitive, objloader, procgen

CELL = "instances.whitted_1080p"
with open(os.path.join(ROOT, "rtbench", "configs", "instances.json")) as _f:
    CONFIG = json.load(_f)
with open(os.path.join(ROOT, "rtbench", "workloads", CELL + ".json")) as _f:
    LIMITS = json.load(_f)["limits"]
MESH_KEYS = ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2")


@pytest.mark.parametrize("name,text", [("cube", procgen.cube_obj()),
                                       ("board", procgen.board_obj(8, 8))])
def test_the_frozen_meshes_are_what_objloader_makes(name, text):
    ours = instances.cube() if name == "cube" else instances.board(8, 8)
    parsed = objloader.parse_obj(text)
    for k, theirs in zip(("v0", "v1", "v2", "uv0", "uv1", "uv2"), parsed[:6]):
        assert ours[k].dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs)
    loaded, built = objloader.loads(text), MeshPrimitive.from_triangles(**ours)
    for k in MESH_KEYS:
        np.testing.assert_array_equal(np.asarray(getattr(built, k)), np.asarray(getattr(loaded, k)))


def test_the_frozen_texture_is_the_ports():
    ours = instances.checkerboard(128, 8)
    assert ours.dtype == np.uint8 and ours.shape == (128, 128, 3)
    np.testing.assert_array_equal(ours, procgen.checkerboard_texture(128, 8))


def test_the_description_is_scene_instances():
    """The port's scene built from the description is ``scene_instances``'
    compiled scene, array for array."""
    desc = scenes.scene(CONFIG)
    assert [len(m["v0"]) for m in desc["meshes"]] == [5120, 12, 2]
    assert scenes.triangle_count(desc) == CONFIG["triangles"] == 5134
    assert (len(desc["materials"]), len(desc["instances"])) == (4, 4)
    ours = system.build_scene(desc, "cpu", False)
    theirs, _ = scene_instances(device="cpu")
    tensors = {k for k, v in vars(theirs).items() if isinstance(v, torch.Tensor)}
    assert {"inst_pose", "inst_scale", "inst_material", "mat_albedo", "mat_reflectivity",
            "tex_atlas", "tri_v0", "tri_uv0"} <= tensors
    for k in sorted(tensors):  # bit for bit; the tables' padding holds NaN
        torch.testing.assert_close(getattr(ours, k), getattr(theirs, k), rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_pose_0_is_scene_instances_camera():
    _, cam = scene_instances(device="cpu")
    table = pose.CameraPath(CONFIG["camera"])
    np.testing.assert_allclose(table.pose[0].numpy(), np.asarray(cam.pose, np.float32),
                               atol=1e-6)
    assert table.period == 720


def test_the_tiny_cell_runs_correct(tiny_run):
    rc, result, _, err = tiny_run(CELL)
    assert rc == 0 and result["correct"] is True, err
    assert result["checks"]["frames_checked"]["value"] >= 2


WIDTH, HEIGHT = 96, 64
POSES = (0, 90, 270, 600)


def _scene():
    """The configuration's description and the port's CPU scene of it."""
    desc = scenes.scene(CONFIG)
    return desc, system.build_scene(desc, "cpu", False)


def _brute(geom, o, d):
    """(t [T], accepted [T]) of one ray against every triangle."""
    t, ok = reference._test(geom.rec[None], o[None, None], d[None, None])
    return t[0], ok[0]


def _causes(ref, o, d, max_bounces=2):
    """What on the reference's path of one pixel's ray can turn a pixel:
    ``outside``, a hit up to EDGE_EPS outside its triangle (the nearest or
    a shadow ray's); ``texel``, a hit on the texture within 1e-3 texel of a
    texel edge; ``tie``, two triangles accepting the ray at t within 1e-5
    of each other."""
    geom, causes = ref.geom, set()
    corners = reference_whitted._corner_uvs(ref, "cpu")
    light = reference.normalize(torch.tensor(reference.LIGHT_DIRECTION))

    def inside(tri, point):
        rec = geom.rec[tri]
        e = point - rec[0:3]
        u, v = reference.dot(rec[6:9], e), reference.dot(rec[9:12], e)
        return u, v, min(float(u), float(v), float(1.0 - u - v))

    for _ in range(max_bounces + 1):
        t, ok = _brute(geom, o, d)
        if not ok.any():
            break
        t = torch.where(ok, t, torch.full_like(t, reference.FLT_MAX))
        tb, tri = t.min(0)
        tri = int(tri)
        if int((t <= tb + 1e-5 * tb.abs()).sum()) > 1:
            causes.add("tie")
        point = o + tb * d
        u, v, least = inside(tri, point)
        if least < 0.0:
            causes.add("outside")
        material = ref.scene["materials"][int(geom.material[tri])]
        tex = material.get("texture")
        if tex is not None:
            uv = (1 - u - v) * corners[0][tri] + v * corners[1][tri] + u * corners[2][tri]
            s = torch.stack([uv[0] * tex.shape[1], (1.0 - uv[1]) * tex.shape[0]])
            if float((s - s.round()).abs().min()) < 1e-3:
                causes.add("texel")
        n = reference.normalize(geom.normal[tri])
        if float(reference.dot(n, light)) > reference_whitted.SHADOW_FLOOR:
            so = point + light * reference.SHADOW_EPS
            ts, oks = _brute(geom, so, light)
            for k in torch.nonzero(oks).flatten().tolist():
                if inside(k, so + ts[k] * light)[2] < 0.0:
                    causes.add("outside")
        if material.get("reflectivity", 0.0) <= 0.0:
            break
        d = reference.normalize(d - 2.0 * reference.dot(d, n) * n)
        o = point + d * reference.SHADOW_EPS
    return causes


def test_the_reference_agrees_with_the_ports_cpu_frames():
    """The port's CPU frames (the plain K3 walk) against the plain Whitted
    reference at 96 x 64 on four poses: within the cell's limits, and
    every pixel that differs by more than one level has a cause.

      * ``walk``: the port's brute-force oracle agrees with the reference
        there, and the reference's path hits up to EDGE_EPS outside a
        triangle, which the walk culls (its boxes are not grown by
        EDGE_EPS: the cube's and the board's rims);
      * ``texel``: the path meets the board's texture on a texel edge,
        where the port's uv, interpolated in object space, and the
        reference's, in world space, round to neighbouring texels (pose
        0's middle column looks down the board's centre line x = 0);
      * ``tie``: two triangles accept a ray at the same t, up to rounding
        (an edge of the mirror sphere: another normal, another
        reflection)."""
    desc, scene = _scene()
    ref = types.SimpleNamespace(geom=reference.Geometry.from_scene(desc, "cpu"), scene=desc)
    _, K_inv, D = pose.intrinsics(WIDTH, HEIGHT, CONFIG["fov_deg"])
    table = pose.CameraPath(CONFIG["camera"])
    walk = RenderConfig(WIDTH, HEIGHT, backend="cuda")
    brute = RenderConfig(WIDTH, HEIGHT, backend="brute")
    found = {}
    for i in POSES:
        p, inv = table.pose[i], table.inv_pose[i]
        port = pipeline.render_image_whitted(walk, scene, K_inv, D, p, inv, 2, True)
        o, d = reference.raygen(WIDTH, HEIGHT, K_inv, D, p, inv, "cpu")
        want = reference_whitted.whitted(ref, (o, d), 2, True)
        r = check.compare(port, want)
        assert all(r[k] <= LIMITS[k] for k in check.NUMBERS), (i, r)
        assert len(torch.unique(want.reshape(-1, 3), dim=0)) >= 20  # not a blank frame
        off = torch.nonzero((port.to(torch.int16) - want.to(torch.int16)).abs().amax(-1) > 1)
        # the port's brute-force oracle on the port's own rays of those pixels
        origin, rays = pipeline._rays(brute, scene, K_inv, D, p, inv)
        oracle = pipeline.whitted_rays(brute, scene, origin, rays[off[:, 0], off[:, 1]], 2, True)
        for (y, x), got in zip(off.tolist(), oracle):
            causes = _causes(ref, o, d[y, x])
            oracle_agrees = int((got.to(torch.int16) - want[y, x].to(torch.int16)).abs().max()) <= 1
            if oracle_agrees and "outside" in causes:
                cause = "walk"
            elif "texel" in causes or "tie" in causes:
                cause = "texel" if "texel" in causes else "tie"
            else:
                cause = None
            assert cause is not None, (i, y, x, port[y, x], want[y, x], got, causes)
            found.setdefault(cause, []).append((i, y, x))
    print("[whitted_diff] " + json.dumps({k: len(v) for k, v in found.items()}))


def test_a_second_bounce_adds_nothing_to_this_scene():
    """Why no test plants one bounce fewer: after the convex mirror no
    live ray is left, so 1 and 2 bounces give the same frame."""
    _, scene = _scene()
    _, K_inv, D = pose.intrinsics(48, 32, CONFIG["fov_deg"])
    table = pose.CameraPath(CONFIG["camera"])
    cfg = RenderConfig(48, 32, backend="cuda")
    for i in (0, 300):
        p, inv = table.pose[i], table.inv_pose[i]
        frames = [pipeline.render_image_whitted(cfg, scene, K_inv, D, p, inv, b, True)
                  for b in (0, 1, 2)]
        assert not torch.equal(frames[0], frames[1])
        assert torch.equal(frames[1], frames[2])


def _no_reflection(monkeypatch):
    orig = system.build_scene

    def build(desc, *rest):
        materials = [{k: v for k, v in m.items() if k != "reflectivity"}
                     for m in desc["materials"]]
        return orig(dict(desc, materials=materials), *rest)

    monkeypatch.setattr(system, "build_scene", build)


def _every_shadow_ray_occluded(monkeypatch):
    from tpu_raytracer_torch.render import integrators

    orig = integrators.occlusion_cast_fn

    def occlusion_cast_fn(backend):
        cast = orig(backend)
        return lambda scene, o, d: cast(scene, o, d)._replace(t=torch.zeros_like(o[..., 0]))

    monkeypatch.setattr(integrators, "occlusion_cast_fn", occlusion_cast_fn)


@pytest.mark.parametrize("fault", [_no_reflection, _every_shadow_ray_occluded],
                         ids=["mirror_reflectivity_ignored", "every_shadow_ray_occluded"])
def test_a_planted_fault_turns_correct_false(tiny_run, monkeypatch, fault):
    """Each at the tiny cell's 48 x 32, the smallest size the harness's
    CPU runs take."""
    fault(monkeypatch)
    rc, result, _, err = tiny_run(CELL)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


def test_shadows_off_changes_no_pixel_of_this_scene():
    """Why the planted fault is "every shadow ray occluded" and not
    "shadows off": config 4's board stands upright at y = 2 facing -y (its
    pose's roll of pi turns ``board_obj``'s x/z plane about y), so the
    light (-0.2, 0, 1) meets it at cos 0 and it shades at the 0.4 floor;
    the surfaces with cos > 0.4 are the tops of the cube and the spheres,
    with nothing above them. No shadow falls where a camera of the
    turntable sees it, and a frame without shadows equals one with them
    (at every other pose of the turntable at 96 x 54 with the full sphere
    too; here every 30th pose of the tiny scene)."""
    desc = scenes.scene(dict(CONFIG, args=CONFIG["tiny"]["args"]))
    scene = system.build_scene(desc, "cpu", False)
    _, K_inv, D = pose.intrinsics(48, 32, CONFIG["fov_deg"])
    table = pose.CameraPath(CONFIG["camera"])
    cfg = RenderConfig(48, 32, backend="cuda")
    for i in range(0, table.period, 30):
        p, inv = table.pose[i], table.inv_pose[i]
        lit, unlit = (pipeline.render_image_whitted(cfg, scene, K_inv, D, p, inv, 2, shadows)
                      for shadows in (True, False))
        assert torch.equal(lit, unlit), i
