"""The port's tracing (``utils/profiling.py``): host spans, set-up spans
and the stage map of a captured frame.

On the CPU: with no profiler ``span`` and ``stage`` record nothing and
return one shared object; under ``torch.profiler`` the ``rt.*`` spans are
in the exported trace as ``user_annotation`` events nested in their frame
and in ``profiling.spans()``; set-up spans are recorded without a
profiler; a ``StageMap`` records nested stages against its counter; the
record stays bounded.

Marked ``gpu`` (skipped without a card; on one, with no JAX, run from the
repository root with
``python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q``):
on a small path frame, AO frame and Whitted frame (config 4), the stage map covers
``0..nodes`` with stages that nest and never partly overlap, a profiled
replay runs exactly ``nodes`` device operations, ``capture_s`` is its
span's duration, and each stage's device ms from a replay (by position
in the graph) agrees within 10% with an eager frame's, where the
profiler's launch correlation puts each kernel in its enclosing ``rt.*``
span.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_raytracer_torch.accel.bvh import sah_cost
from tpu_raytracer_torch.app.scenes import scene_instances
from tpu_raytracer_torch.render import Camera, RenderConfig, pipeline
from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, mesh, procgen
from tpu_raytracer_torch.kernels.wide4 import wide_sah
from tpu_raytracer_torch.utils import profiling, prng

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("raygen", "cast", "attrs", "sample", "bounce", "light", "shade", "output")


def _scene(device, subdivisions=1, cache_dir=False):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(subdivisions),
                                                cache_dir=cache_dir))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(24, 16, fov_deg=55.0, pose=[0, -3.5, 0, 0, 0, 0])
    return scene.compile(device), cam


def _args(cam, device):
    p = cam.ray_params(device)
    return p["K_inv"], p["D"], p["pose"], p["inv_pose"]


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


def test_off_without_a_profiler_records_nothing(record):
    before = profiling.spans()
    a, b, c = profiling.span("frame", 3), profiling.span("bind"), profiling.stage("sample")
    assert a is b is c
    with a, c:
        prng.uniform(prng.PRNGKey(1), (4,))
    assert profiling.spans() == before == []


def test_rt_spans_in_the_trace_nested_in_their_frame(record, tmp_path):
    scene, cam = _scene("cpu")
    cfg = RenderConfig(cam.width, cam.height, backend="bvh")
    key = prng.PRNGKey(5)
    frame = lambda: pipeline.compiled_render_image_path_traced(cfg, scene, *_args(cam, "cpu"),
                                                               key, 1, 2)
    setup = profiling.spans()
    frame()  # frame 0, untraced
    assert profiling.spans() == setup
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
        frame()
    pipeline.clear_compiled()
    rec = profiling.spans()
    frames = {s.frame for s in rec}
    assert frames == {1, 2}
    by_frame = {f: [s for s in rec if s.frame == f] for f in frames}
    for f, spans in by_frame.items():
        top = [s for s in spans if s.name == "frame"]
        assert len(top) == 1 and top[0].parent is None
        names = {s.name for s in spans}
        assert {"bind", "raygen", "cast", "attrs", "sample", "bounce", "output"} <= names
        for s in spans:
            assert top[0].t0_ns <= s.t0_ns <= s.t1_ns <= top[0].t1_ns
            assert s.name == "frame" or s.parent is not None
    assert {s.parent for s in rec if s.name == "bind"} == {"frame"}
    assert "bounce" in {s.parent for s in rec if s.name == "sample"}

    ann = [e for e in _events(prof, tmp_path)
           if e.get("cat") == "user_annotation" and e["name"].startswith("rt.")]
    tops = {e["name"]: e for e in ann if e["name"].startswith("rt.frame.")}
    assert set(tops) == {"rt.frame.1", "rt.frame.2"}
    inner = [e for e in ann if not e["name"].startswith("rt.frame.")]
    assert len(inner) == sum(1 for s in rec if s.name != "frame")
    for e in inner:
        assert any(t["ts"] <= e["ts"] and e["ts"] + e["dur"] <= t["ts"] + t["dur"]
                   for t in tops.values()), e["name"]
    assert {e["name"] for e in inner} == {"rt." + s.name for s in rec if s.name != "frame"}


@pytest.mark.parametrize("opt_rounds", [0, 2])
def test_setup_spans_without_a_profiler(record, tmp_path, monkeypatch, opt_rounds):
    """A build and a cache hit of one tree: ``setup.bvh``'s info (the
    tree's ``sah`` on both), ``setup.optimize`` inside the build alone
    where it runs the optimizer, ``setup.compile``'s wide tables' SAH."""
    monkeypatch.setattr(mesh, "CACHE_MIN_TRIS", 0)
    v = procgen.colonnade(3, 3, 8, bands=8)
    trees, scenes = [], []
    for _ in range(2):
        m = MeshPrimitive.from_triangles(*v, opt_rounds=opt_rounds, cache_dir=str(tmp_path))
        scene = Scene()
        scene.add_material(Material())
        scene.add_mesh(m)
        scene.add_mesh_instance(MeshInstance(0, 0))
        trees.append(m.bvh)
        scenes.append(scene.compile("cpu"))
    rec = profiling.spans()
    bvh = [s for s in rec if s.name == "setup.bvh"]
    sah = sah_cost(trees[0])
    assert sah_cost(trees[1]) == sah
    assert [s.info for s in bvh] == [
        {"cache_hit": hit, "opt_rounds": opt_rounds, "triangles": len(v[0]), "sah": sah}
        for hit in (False, True)]
    opt = [s for s in rec if s.name == "setup.optimize"]
    if opt_rounds:
        (o,) = opt
        assert o.parent == "setup.bvh" and bvh[0].t0_ns <= o.t0_ns <= o.t1_ns <= bvh[0].t1_ns
        assert o.info["rounds"] == 2 and 1 <= o.info["rounds_kept"] <= 2
        assert o.info["sah_after"] == sah < o.info["sah_before"]
        assert o.info["sah_before"] == sah_cost(mesh.build_mesh_bvh(*v, cache_dir=False))
    else:
        assert opt == []
    compiles = [s for s in rec if s.name == "setup.compile"]
    assert len(compiles) == 2 and all(s.t1_ns > s.t0_ns and s.parent is None for s in compiles)
    for s, scene in zip(compiles, scenes):
        assert s.info == {"wide_sah": [wide_sah(scene.wide4)[0][0]],
                          "wide_triangles": [len(v[0])]}
    assert {s.name for s in rec} == {"setup.bvh", "setup.compile"} | (
        {"setup.optimize"} if opt_rounds else set())


def _direct_wide_sah(code, box, root):
    """A mesh's 4-wide SAH, walked node by node in float64."""
    def half_area(lo, hi):
        s = hi - lo
        return s[0] * (s[1] + s[2]) + s[1] * s[2]

    total, tris, root_area, stack = 0.0, 0, None, [root]
    while stack:
        w = stack.pop()
        kids = [c for c in range(4) if code[w, c] != -1]
        lo = np.min([box[w, 6 * c:6 * c + 3] for c in kids], axis=0)
        hi = np.max([box[w, 6 * c + 3:6 * c + 6] for c in kids], axis=0)
        area = half_area(lo, hi)
        root_area = area if root_area is None else root_area
        total += area
        for c in kids:
            if code[w, c] >= 0:
                stack.append(code[w, c])
            else:
                n = (-code[w, c] - 1) % 1024
                total += half_area(box[w, 6 * c:6 * c + 3], box[w, 6 * c + 3:6 * c + 6]) * n
                tris += n
    return total / root_area, tris


def test_wide_sah_is_the_sum_over_the_tables_of_each_mesh(record):
    """Config 4 (three meshes under four instances): the compile's
    ``wide_sah`` is each mesh's sum over its 4-wide nodes and leaves."""
    scene = scene_instances(32, 24, device="cpu")[0]
    code = scene.wide4.wcode.numpy()
    box = scene.wide4.wbox.numpy().astype(np.float64)
    roots = scene.wide4.wroot.tolist()
    want = [_direct_wide_sah(code, box, r) for r in roots]
    got = wide_sah(scene.wide4)
    assert [t for _, t in got] == [t for _, t in want] == [5120, 12, 2]
    np.testing.assert_allclose([c for c, _ in got], [c for c, _ in want], rtol=1e-5)
    (s,) = [s for s in profiling.spans() if s.name == "setup.compile"]
    assert s.info == {"wide_sah": [c for c, _ in got], "wide_triangles": [5120, 12, 2]}


def test_a_stage_map_records_nested_stages_against_its_counter(record):
    ops = []
    stages = profiling.StageMap(lambda: len(ops))
    assert profiling.stage("cast") is profiling.span("cast")  # no capture, no profiler
    with stages:
        ops.append(0)
        with profiling.stage("bounce"):
            ops.append(1)
            with profiling.stage("sample"):
                ops += [2, 3]
            with profiling.stage("cast"):
                pass
            ops.append(4)
        with profiling.stage("output"):
            ops.append(5)
    assert stages.stages == [("bounce", 1, 5), ("sample", 2, 4), ("cast", 4, 4), ("output", 5, 6)]
    assert profiling.spans() == []  # no profiler: the map alone
    assert profiling.stage("cast") is profiling.span("cast")  # the map closed


def _stage_sequence(frame):
    """(name, parent) of each stage an eager ``frame()`` enters, in order."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        frame()
    return [(s.name, s.parent) for s in sorted(profiling.spans(), key=lambda s: s.t0_ns)
            if s.name in STAGES]


def test_an_eager_whitted_frame_records_its_stages_in_order(record):
    """The first cast's rays, then each bounce: the nearest cast, the
    attributes, the light (its shadow rays' any-hit cast nested in it), the
    shading (the first makes the radiance's state); then the output."""
    scene, cam = scene_instances(16, 12, device="cpu")
    cfg = RenderConfig(cam.width, cam.height, backend="cuda")
    got = _stage_sequence(lambda: pipeline.render_image_whitted(cfg, scene, *_args(cam, "cpu"),
                                                                2, True))
    bounce = [("cast", None), ("attrs", None), ("light", None), ("cast", "light"),
              ("shade", None)]
    assert got == [("raygen", None), ("cast", None)] + 3 * bounce + [("output", None)]


def test_a_path_frames_stages_are_as_they_were(record):
    """The primary cast and attributes, then the bounces in one ``bounce``
    stage (the first makes the radiance's state, as ``path_bounce``
    does), each bounce's draw and the next cast nested in it, the tail's
    any-hit cast; then the output."""
    scene, cam = scene_instances(16, 12, device="cpu")
    cfg = RenderConfig(cam.width, cam.height, backend="cuda")
    got = _stage_sequence(lambda: pipeline.render_image_path_traced(
        cfg, scene, *_args(cam, "cpu"), prng.PRNGKey(3), 2, 2))
    draw = [("sample", "bounce")] + 5 * [("sample", "sample")]  # prng's own, on the CPU
    assert got == ([("raygen", None), ("cast", None), ("attrs", None), ("bounce", None)] + draw + [("cast", "bounce"), ("attrs", "bounce")] + draw
                   + [("cast", "bounce"), ("output", None), ("output", None)])


def test_the_record_stays_bounded(record):
    for i in range(profiling.MAX_SPANS + 7):
        with profiling.setup("bvh") as span:
            span.info = {"i": i}
    rec = profiling.spans()
    assert len(rec) == profiling.MAX_SPANS
    assert rec[0].info == {"i": 7} and rec[-1].info == {"i": profiling.MAX_SPANS + 6}


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_scene(device):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.8, 0.8)))
    v0, v1, v2 = procgen.colonnade(4, 4, 16)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2, cache_dir=False))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(512, 384, fov_deg=65.0, pose=[1.0, -2.0, 1.6, 0, 0, 0])
    return scene.compile(str(device)), cam


def _card_frames(device):
    scene, cam = _card_scene(device)
    cfg = RenderConfig(cam.width, cam.height, backend="cuda")
    key = prng.PRNGKey(2 ** 31 + 11, device=device)
    args = (cfg, scene) + _args(cam, device) + (key,)
    return {"path": (pipeline.compiled_render_image_path_traced,
                     pipeline.render_image_path_traced, args + (2, 2)),
            "ao": (pipeline.compiled_render_image_ao, pipeline.render_image_ao,
                   args + (8, 1.0)),
            "whitted": _card_whitted(device)}


def _card_whitted(device):
    scene, cam = scene_instances(512, 384, device=str(device))
    args = (RenderConfig(cam.width, cam.height, backend="cuda"), scene) + _args(cam, device)
    return (pipeline.compiled_render_image_whitted, pipeline.render_image_whitted,
            args + (2, True))


# the stages whose device ms a replay and an eager frame must agree on
COMPARED = {"path": ("sample", "bounce"), "ao": ("sample", "bounce"),
            "whitted": ("light", "shade")}


def _innermost(stages, nodes):
    labels = [None] * nodes
    for name, first, end in stages:  # entered order: a nested stage after its outer one
        labels[first:end] = [name] * (end - first)
    return labels


def _replay_stage_ms(entry, device, tmp_path, reps=3):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            entry.graph.replay()
        torch.cuda.synchronize(device)
    ops = sorted((e for e in _events(prof, tmp_path) if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    labels = _innermost(entry.stages, entry.nodes)
    ms = {}
    for i, e in enumerate(ops):
        ms[labels[i % entry.nodes]] = ms.get(labels[i % entry.nodes], 0.0) + e["dur"] / 1e3 / reps
    return len(ops), ms


def _eager_stage_ms(fn, args, device, tmp_path, reps=3):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize(device)
    events = _events(prof, tmp_path)
    ann = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("rt.")]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ms = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        src = launch.get(e.get("args", {}).get("correlation"))
        label = None
        if src is not None:
            around = [a for a in ann if a["tid"] == src["tid"]
                      and a["ts"] <= src["ts"] < a["ts"] + a["dur"]]
            if around:
                label = max(around, key=lambda a: a["ts"])["name"][len("rt."):]
        ms[label] = ms.get(label, 0.0) + e["dur"] / 1e3 / reps
    return ms


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["path", "ao", "whitted"])
def test_stage_map_of_a_captured_frame(cuda, kind, record, tmp_path):
    compiled, eager, args = _card_frames(cuda)[kind]
    compiled(*args)
    entry = compiled.last
    cap = [s for s in profiling.spans() if s.name == "setup.capture"]
    assert len(cap) == 1 and entry.capture_s == (cap[-1].t1_ns - cap[-1].t0_ns) / 1e9
    assert entry.nodes >= sum(entry.launches.values())
    covered = np.zeros(entry.nodes, bool)
    for name, first, end in entry.stages:
        assert name in STAGES and 0 <= first <= end <= entry.nodes
        covered[first:end] = True
    assert covered.all(), np.nonzero(~covered)[0][:20]
    for i, (_, a0, a1) in enumerate(entry.stages):  # nested or apart, never partly over
        for _, b0, b1 in entry.stages[i + 1:]:
            assert b1 <= a0 or b0 >= a1 or (a0 <= b0 and b1 <= a1), (a0, a1, b0, b1)

    n_ops, replay = _replay_stage_ms(entry, cuda, tmp_path)
    assert n_ops == 3 * entry.nodes
    eager_ms = _eager_stage_ms(eager, args, cuda, tmp_path)
    print(f"[tracing_gpu] {kind} nodes={entry.nodes} replay_ms={json.dumps(replay)} "
          f"eager_ms={json.dumps(eager_ms)}")
    for name in COMPARED[kind]:
        assert abs(eager_ms[name] - replay[name]) <= 0.10 * replay[name], name
    pipeline.clear_compiled()
