"""A new kind of scene and a new entry come in as new files only: in a copy
of the checkout's ``rtbench/`` a generator of two meshes under three
posed, non-uniformly scaled instances and two materials (one textured),
an entry module, a traffic mix with ``render`` options, a workload file
and ``BENCHMARK.json`` entries make a cell that runs correct, with every
file that was there unchanged. The reference's instancing has teeth, its
baked frame agrees with the port's CPU renders, and an identity instance
leaves today's geometry as it is."""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from rtbench import check, pose, reference, scenes, spec, system

GENERATOR = '''"""Two meshes (an icosphere, a uv-mapped board) under three posed,
non-uniformly scaled instances, and two materials, the board's textured."""

import numpy as np

from rtbench import scenes


def _board(n):
    g = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    x0, y0 = (a.reshape(-1) for a in np.meshgrid(g[:-1], g[:-1], indexing="ij"))
    x1, y1 = x0 + np.float32(2.0 / n), y0 + np.float32(2.0 / n)
    z = np.zeros_like(x0)
    a, b = np.stack([x0, y0, z], -1), np.stack([x1, y0, z], -1)
    c, d = np.stack([x1, y1, z], -1), np.stack([x0, y1, z], -1)
    uv = lambda p: ((p[:, :2] + 1.0) / 2.0).astype(np.float32)
    cat = lambda *p: np.concatenate(p).astype(np.float32)
    return {"v0": cat(a, a), "v1": cat(b, c), "v2": cat(c, d),
            "uv0": cat(uv(a), uv(a)), "uv1": cat(uv(b), uv(c)), "uv2": cat(uv(c), uv(d))}


def _checker(size, cell):
    odd = ((np.arange(size)[:, None] // cell + np.arange(size)[None, :] // cell) % 2)[..., None]
    return np.where(odd == 1, np.uint8([200, 60, 30]), np.uint8([40, 160, 220])).astype(np.uint8)


def scene(subdivisions, board):
    v0, v1, v2 = scenes.icosphere(subdivisions)
    f = lambda *x: np.array(x, np.float32)
    return {"meshes": [{"v0": v0, "v1": v1, "v2": v2}, _board(board)],
            "materials": [{"albedo": (0.9, 0.5, 0.2)},
                          {"albedo": (1.0, 1.0, 1.0), "texture": _checker(16, 4)}],
            "instances": [(1, 1, f(0.0, 0.0, -1.0, 0.3, 0.0, 0.0), f(4.0, 3.5, 1.0)),
                          (0, 0, f(-0.7, 0.3, -0.3, 0.5, 0.2, 0.1), f(0.6, 0.5, 0.9)),
                          (0, 0, f(0.8, -0.4, -0.5, 1.0, 0.0, 0.3), f(0.4, 0.7, 0.5))]}
'''

ENTRY = '''"""Primary frames of a scene of several materials through
``compiled_render_image``; the reference shades each hit by its
material's albedo or texture (nearest texel at the hit's uv)."""

import numpy as np
import torch

from rtbench import reference as plain

KEYED = False
COMPILED = "compiled_render_image"
TEXEL_SCALE = 0.0039215


def bind(pipeline, scene, cfg, traffic):
    entry = pipeline.compiled_render_image
    return lambda K_inv, D, pose, inv_pose, key: entry(cfg, scene, K_inv, D, pose, inv_pose)


def _uv(ref, tri, u, v):
    meshes, dev = ref.scene["meshes"], ref.geom.device
    start = torch.tensor(np.cumsum([0] + [len(m["v0"]) for m in meshes[:-1]]), device=dev)
    row = start[ref.geom.mesh[tri]] + ref.geom.local[tri]
    corner = lambda c: torch.from_numpy(np.concatenate([np.asarray(
        m.get(c, np.zeros((len(m["v0"]), 2))), np.float32) for m in meshes])).to(dev)[row]
    w = (1.0 - u - v)[..., None]
    return w * corner("uv0") + v[..., None] * corner("uv1") + u[..., None] * corner("uv2")


def reference(ref, rays, key, config, traffic):
    o, d = rays
    h = plain.Hits(ref.geom, o, d)
    tri = torch.clamp(h.tri, min=0)
    rec = ref.geom.rec[tri]
    e = h.location - rec[..., 0:3]
    uv = _uv(ref, tri, plain.dot(rec[..., 6:9], e), plain.dot(rec[..., 9:12], e))
    mat = ref.geom.material[tri]
    color = torch.zeros(mat.shape + (3,), dtype=torch.float32, device=d.device)
    for k, m in enumerate(ref.scene["materials"]):
        tex = m.get("texture")
        if tex is None:
            value = torch.tensor(m["albedo"], dtype=torch.float32, device=d.device)
        else:
            th, tw = tex.shape[:2]
            x = torch.clamp(torch.fmod((uv[..., 0] * tw).to(torch.int32), tw), min=0)
            y = torch.clamp(torch.fmod(((1.0 - uv[..., 1]) * th).to(torch.int32), th), min=0)
            texels = torch.from_numpy(tex).to(d.device).to(torch.float32)
            value = texels[y.long(), x.long()] * TEXEL_SCALE
        color = torch.where((mat == k)[..., None], value, color)
    return plain.shade(h, d, color, traffic.get("lighting", "flat"))
'''

CONFIG = {
    "name": "few_instances", "source": "a scene made for the harness's own tests",
    "generator": "few_instances", "args": {"subdivisions": 2, "board": 4},
    "albedo": [0.9, 0.5, 0.2], "fov_deg": 60.0,
    "camera": {"path": "turntable", "center": [0.0, 0.0], "radius": 4.5, "height": 0.2,
               "step_deg": 7.5},
    "precision": "float32", "assumed": [], "reduced": [],
}
TRAFFIC = {"entry": "material_image", "width": 96, "height": 64, "lighting": "lambert",
           "render": {"normal_mode": "inverse_transpose", "backend": "brute"},
           "check_frames": 3, "check_within": 4, "trace_start": 2, "trace_frames": 2}
CELL = "few_instances.lambert"
NEW = {
    "rtbench/generators/few_instances.py": GENERATOR,
    "rtbench/entries/material_image.py": ENTRY,
    "rtbench/configs/few_instances.json": json.dumps(CONFIG),
    "rtbench/traffic/lambert.json": json.dumps(TRAFFIC),
    "rtbench/workloads/few_instances.lambert.json": json.dumps(
        {"limits": {"px_off_pct": 1.0, "mean_abs": 0.5}}),
}


def _hashes(root):
    out = {}
    for d, dirs, files in os.walk(os.path.join(root, "rtbench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def opened(tmp_path_factory):
    """A checkout of ``rtbench/``, ``BENCHMARK.json`` and the port (linked),
    with the new cell added as files and ``BENCHMARK.json`` entries; the
    hashes of the files that were there before."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(ROOT, "rtbench"), os.path.join(root, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".rtbench_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "tpu_raytracer_torch"), os.path.join(root, "tpu_raytracer_torch"))
    before = _hashes(root)
    for rel, text in NEW.items():
        assert not os.path.exists(os.path.join(root, rel)), rel
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    bench = spec.benchmark(root)
    bench["configs"].append({"name": CONFIG["name"], "source": CONFIG["source"],
                             "file": "rtbench/configs/few_instances.json", "reduced": [],
                             "why": "instances, materials, a texture"})
    bench["workloads"].append({"name": CELL, "config": CONFIG["name"], "traffic": "lambert",
                               "chips": 1, "why": "a new entry with render options"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, before


RUN = """
import json, sys
import numpy as np
sys.path.insert(0, "rtbench/tests")
import conftest
from rtbench import check, run
if {identity_pose!r}:
    init = check.Reference.__init__
    def ident(self, config, traffic, desc, *a):
        inst = list(desc["instances"])
        m, mat, _, scale = inst[1]
        inst[1] = (m, mat, np.zeros(6, np.float32), scale)
        init(self, config, traffic, dict(desc, instances=inst), *a)
    check.Reference.__init__ = ident
sys.exit(run.main(["--workload", {cell!r}, "--seed", "2147483999", "--seconds", "1.0",
                   "--trace", "0"], device="cpu", cell=conftest.tiny_cell({cell!r})))
"""


def _run(root, identity_pose):
    r = subprocess.run([sys.executable, "-c", RUN.format(cell=CELL, identity_pose=identity_pose)],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_new_scene_and_entry_as_files_only_run_correct(opened):
    root, before = opened
    result = _run(root, identity_pose=False)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["frames_checked"]["value"] == 3
    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(NEW)


def test_the_references_instancing_has_teeth(opened):
    root, _ = opened
    result = _run(root, identity_pose=True)
    assert result["correct"] is False, result["checks"]


def _load(source, name, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(source)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend", ["brute", "cuda"])
def test_the_baked_reference_agrees_with_the_ports_cpu_render(backend, tmp_path):
    """Within the bounds of ``test_the_reference_agrees_with_a_tiny_cpu_render``
    of the port's frames through its brute-force oracle and through the
    plain K3 (a scene of several instances walks the TLAS)."""
    from tpu_raytracer_torch.render import RenderConfig, pipeline

    desc = _load(GENERATOR, "few_instances", tmp_path).scene(**CONFIG["args"])
    entry = _load(ENTRY, "material_image", tmp_path)
    width, height = 96, 64
    _, K_inv, D = pose.intrinsics(width, height, CONFIG["fov_deg"])
    table = pose.CameraPath(CONFIG["camera"])
    cfg = RenderConfig(width, height, backend=backend, lighting="lambert",
                       normal_mode="inverse_transpose")
    scene = system.build_scene(desc, "cpu", False)
    ref = types.SimpleNamespace(geom=reference.Geometry.from_scene(desc, "cpu"), scene=desc)
    for i in (0, 5, 17):
        p, inv = table.pose[i], table.inv_pose[i]
        port = pipeline.render_image(cfg, scene, K_inv, D, p, inv)
        rays = reference.raygen(width, height, K_inv, D, p, inv, "cpu")
        want = entry.reference(ref, rays, None, CONFIG, TRAFFIC)
        assert port.shape == want.shape == (height, width, 3)
        r = check.compare(port, want)
        assert r["px_off_pct"] <= 0.5 and r["mean_abs"] <= 0.2, (i, r)
        # every material and instance shows: sky, both checker colours, both spheres
        assert len(torch.unique(want.reshape(-1, 3), dim=0)) >= 8
        hits = reference.Hits(ref.geom, *rays)
        assert set(ref.geom.instance[hits.tri[hits.hit]].tolist()) == {0, 1, 2}


@pytest.mark.parametrize("config", [
    {"generator": "blob", "args": {"subdivisions": 2, "seed": 7}, "albedo": [0.8, 0.3, 0.2]},
    {"generator": "colonnade", "args": {"columns_x": 2, "columns_y": 2, "segs": 8, "bands": 3},
     "albedo": [0.85, 0.8, 0.75]},
], ids=["blob", "colonnade"])
@pytest.mark.parametrize("precision", reference.PRECISIONS)
def test_an_identity_instance_leaves_the_geometry_as_it_is(config, precision):
    desc = scenes.scene(config)
    assert len(desc["meshes"]) == len(desc["materials"]) == len(desc["instances"]) == 1
    mesh = desc["meshes"][0]
    for a, b in zip((mesh["v0"], mesh["v1"], mesh["v2"]), scenes.GENERATORS[config["generator"]](
            **config["args"])):
        np.testing.assert_array_equal(a, b)
    baked = reference.Geometry.from_scene(desc, "cpu", precision)
    plain = reference.Geometry(mesh["v0"], mesh["v1"], mesh["v2"], "cpu", precision)
    for k in ("rec", "normal", "bmin", "bmax", "valid", "leaf_tri", "leaf_rec", "leaf_ok",
              "instance", "mesh", "material", "local"):
        assert torch.equal(getattr(baked, k), getattr(plain, k)), k
    assert (baked.depth, baked.first_leaf) == (plain.depth, plain.first_leaf)
    assert torch.equal(baked.local, torch.arange(len(mesh["v0"])))
    assert scenes.triangle_count(desc) == len(mesh["v0"])


def test_an_unknown_generator_or_entry_names_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"generators.no_such_scene\.py"):
        scenes.scene({"generator": "no_such_scene", "args": {}})
    with pytest.raises(FileNotFoundError, match=r"entries.no_such_entry\.py"):
        spec.entry("no_such_entry")
