"""The plain reference: its walk answers as testing every triangle
would, its frames agree with the port's CPU renders at small sizes, and
its control (bfloat16 geometry) does not."""

import pytest
import torch

from rtbench import check, pose, reference, scenes, spec, system

SCENES = {
    "blob": {"generator": "blob", "args": {"subdivisions": 3, "seed": 7},
             "albedo": [0.85, 0.8, 0.75]},
    "colonnade": {"generator": "colonnade",
                  "args": {"columns_x": 3, "columns_y": 3, "segs": 8, "bands": 6},
                  "albedo": [0.85, 0.8, 0.75]},
}


def _tris(name):
    mesh = scenes.scene(SCENES[name])["meshes"][0]
    return mesh["v0"], mesh["v1"], mesh["v2"]


def _brute(geom, o, d, t_max=reference.FLT_MAX):
    t, ok = reference._test(geom.rec[None], o[:, None], d[:, None])
    t = torch.where(ok & (t < t_max), t, torch.full_like(t, reference.FLT_MAX))
    tmin, tri = t.min(1)  # the first of equal minima
    return tmin, torch.where(tmin < reference.FLT_MAX, tri, torch.full_like(tri, -1))


def _rays(tris, n, gen):
    """Rays from random origins toward random points of random triangles,
    a quarter of them aimed just past an edge (inside EDGE_EPS)."""
    v0, v1, v2 = (torch.from_numpy(v) for v in tris)
    lo, hi = torch.cat([v0, v1, v2]).amin(0), torch.cat([v0, v1, v2]).amax(0)
    o = lo + (hi - lo) * (torch.rand(n, 3, generator=gen) * 1.6 - 0.3)
    k = torch.randint(0, len(v0), (n,), generator=gen)
    u, v = torch.rand(n, generator=gen), torch.rand(n, generator=gen)
    flip = u + v > 1
    u, v = torch.where(flip, 1 - u, u), torch.where(flip, 1 - v, v)
    edge = torch.arange(n) % 4 == 0
    u = torch.where(edge, -0.0005 * torch.rand(n, generator=gen), u)
    p = v0[k] + u[:, None] * (v2[k] - v0[k]) + v[:, None] * (v1[k] - v0[k])
    return o, reference.normalize(p - o)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("t_max", [reference.FLT_MAX, 0.7])
@pytest.mark.parametrize("tail", [0, 500])
def test_the_walk_finds_what_testing_every_triangle_finds(name, t_max, tail):
    tris = _tris(name)
    geom = reference.Geometry(*tris, "cpu")
    o, d = _rays(tris, 3000, torch.Generator().manual_seed(1))
    t, tri = reference.cast(geom, o, d, t_max, tail=tail)
    expect, expect_tri = _brute(geom, o, d, t_max)
    assert torch.equal(t, expect)
    assert torch.equal(tri, expect_tri)
    assert torch.equal(tri >= 0, expect < reference.FLT_MAX)
    assert (tri >= 0).float().mean() > 0.02
    t_any, tri_any = reference.cast(geom, o, d, t_max, any_hit=True, tail=tail)
    assert torch.equal(tri_any >= 0, tri >= 0)


CASES = {
    "flat": ("blob", {"entry": "image", "lighting": "flat"}, [0, -3.2, 0.13, 0.2, 0, 0], 50.0),
    "blinn_phong": ("blob", {"entry": "image", "lighting": "blinn_phong"},
                    [0, -3.2, 0.13, 0.0, 0, 0], 50.0),
    "path": ("colonnade", {"entry": "path_traced", "samples": 2, "max_bounces": 2},
             [0.5, 0.5, 1.6, 0.7, 0, 0], 65.0),
    "ao": ("colonnade", {"entry": "ao", "samples": 4, "radius": 3.0},
           [0.5, 0.5, 1.6, 0.7, -0.3, 0], 65.0),
}


def _frame(case, precision="float32", width=40, height=24, backend="brute"):
    from tpu_raytracer_torch.render import RenderConfig, pipeline

    name, traffic, p, fov = CASES[case]
    traffic = dict(traffic, width=width, height=height)
    config = SCENES[name]
    desc = scenes.scene(config)
    _, K_inv, D = pose.intrinsics(width, height, fov)
    p = torch.tensor(p, dtype=torch.float32)
    inputs = (K_inv, D, p, pose.invert_lre(p), check.prng.frame_key(12345, 3))
    ref = check.Reference(config, traffic, desc, "cpu", precision).frame(*inputs)
    scene = system.build_scene(desc, "cpu", False)
    cfg = RenderConfig(width, height, backend=backend, lighting=traffic.get("lighting", "flat"))
    if traffic["entry"] == "image":
        port = pipeline.render_image(cfg, scene, *inputs[:4])
    elif traffic["entry"] == "path_traced":
        port = pipeline.render_image_path_traced(cfg, scene, *inputs, traffic["max_bounces"],
                                                 traffic["samples"])
    else:
        port = pipeline.render_image_ao(cfg, scene, *inputs, traffic["samples"],
                                        traffic["radius"])
    return port, ref


@pytest.mark.parametrize("name", SCENES)
def test_the_walk_finds_the_ports_oracle_t(name):
    """The same t as the port's brute-force oracle on every ray; of equal
    t the two may name other triangles (the port numbers them in its BVH's
    order, the reference in the configuration's)."""
    from tpu_raytracer_torch.render.renderer import cast_rays_brute

    tris = _tris(name)
    o, d = _rays(tris, 4000, torch.Generator().manual_seed(3))
    t, _ = reference.cast(reference.Geometry(*tris, "cpu"), o, d)
    scene = system.build_scene(scenes.scene(SCENES[name]), "cpu", False)
    assert torch.equal(t, cast_rays_brute(scene, o, d).t)


@pytest.mark.parametrize("backend", ["brute", "cuda"])
@pytest.mark.parametrize("case", CASES)
def test_the_reference_agrees_with_a_tiny_cpu_render(case, backend):
    """Within a few pixels of the port's CPU frames through its
    brute-force oracle and through its BVH walk (the plain K1): where
    they differ, a t tie went to another triangle, or the walk culled a
    hit up to EDGE_EPS outside its leaf's box."""
    port, ref = _frame(case, backend=backend)
    assert port.shape == ref.shape == (24, 40, 3) and ref.dtype == torch.uint8
    assert len(torch.unique(ref.reshape(-1, 3), dim=0)) >= 2  # not a blank frame
    r = check.compare(port, ref)
    assert r["px_off_pct"] <= 0.5 and r["mean_abs"] <= 0.2, r


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_each_cells_check(cell, monkeypatch):
    """The control (the reference with bfloat16 geometry, in the port's
    place) against the reference, at the cell's configuration, camera
    path and traffic cut to 96 x 54: the check calls it not correct. (On
    the CPU every ray walks to its end: testing every triangle is the
    card's shortcut for the last few.)"""
    monkeypatch.setattr(reference, "TAIL", 0)
    c = spec.Cell(cell)
    traffic = dict(c.traffic, width=96, height=54)
    desc = scenes.scene(c.config)
    camera = pose.CameraPath(c.config["camera"])
    intr = pose.intrinsics(96, 54, c.config["fov_deg"])
    ref = check.Reference(c.config, traffic, desc, "cpu")
    low = check.Reference(c.config, traffic, desc, "cpu", "bfloat16")
    inp = check.inputs(camera, intr, 2 ** 31 + 9, 157)
    readings = [check.compare(low.frame(*inp), ref.frame(*inp))]
    correct, checks = check.judge(readings, [], c.limits)
    assert correct is False, checks
