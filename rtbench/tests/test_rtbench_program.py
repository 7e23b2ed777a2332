"""``rtbench/program.py``, the readers' view of what the port records of
itself: the split of the traced device operations into calls and
replays, each replayed operation's innermost stage, the host and set-up
spans; and every reader that uses it returning None on a CPU run, where
no entry is captured."""

import types

import pytest

from rtbench import program, spec

NEW = ("sampling_ms", "bounce_ms", "bind_host_ms", "replay_host_ms", "setup_scene_s",
       "setup_library_s", "setup_capture_s")

# a replay of 6 nodes: raygen 0, cast 1, bounce 2-5 holding sample 3-4
STAGES = [("raygen", 0, 1), ("cast", 1, 2), ("bounce", 2, 6), ("sample", 3, 5)]


def _ops(frames, nodes=6, bind=2, clone=1, t0=100.0):
    """Device operations of ``frames`` calls: ``bind`` copies, a replay
    whose node k lasts k + 1 us, ``clone`` copies; given out of order."""
    ops, t = [], t0
    for _ in range(frames):
        call = [("Memcpy HtoD", 0.5, "gpu_memcpy")] * bind
        call += [(f"kernel{k}", k + 1.0, "kernel") for k in range(nodes)]
        call += [("Memcpy DtoD", 0.25, "gpu_memcpy")] * clone
        for name, dur, cat in call:
            ops.append((name, t, dur, cat))
            t += dur + 1.0
    return ops[::-1]


def test_innermost_takes_the_nested_stage():
    assert program.innermost(STAGES, 7) == ["raygen", "cast", "bounce", "sample", "sample",
                                            "bounce", None]
    assert program.innermost([("a", 0, 4), ("b", 1, 1)], 4) == ["a"] * 4  # an empty stage


def test_replays_split_by_position_into_their_stages():
    ms, why = program.attribute(_ops(3), 3, 6, STAGES, bind_ops=2, clone_ops=1)
    assert why == ""
    assert ms == pytest.approx({"raygen": 0.001, "cast": 0.002, "bounce": 0.003 + 0.006,
                                "sample": 0.004 + 0.005})
    ms, _ = program.attribute(_ops(2, nodes=6, bind=0, clone=0), 2, 6, STAGES[:3])
    assert ms["bounce"] == pytest.approx(0.003 + 0.004 + 0.005 + 0.006)


def test_a_count_mismatch_gives_none():
    ms, why = program.attribute(_ops(3)[1:], 3, 6, STAGES, bind_ops=2, clone_ops=1)
    assert ms is None and why.startswith("count mismatch: 26 traced device operations")
    ms, why = program.attribute(_ops(3), 3, 6, STAGES, bind_ops=1, clone_ops=2)
    assert ms is None and "not copies" in why
    assert program.attribute([], 0, 6, STAGES)[0] is None


def test_union_counts_an_interval_inside_another_once():
    assert program.union_s([(0, 10), (2, 4), (12, 15), (14, 20)]) == 18e-9
    assert program.union_s([]) == 0.0


def _ctx(device_ops, frames):
    trace = types.SimpleNamespace(device_ops=device_ops, frames=frames)
    return types.SimpleNamespace(trace=trace, traffic={"entry": "path_traced"})


def test_the_readers_on_a_captured_entry(monkeypatch, capsys):
    entry = types.SimpleNamespace(nodes=6, stages=STAGES, bind_ops=2, clone_ops=1)
    monkeypatch.setattr(program, "entry", lambda traffic: entry)
    record = {"bind": [(0, 150_000), (10, 110_010), (20, 200_020)], "replay": [(0, 2_000_000)],
              "setup.bvh": [(0, 10**9)], "setup.compile": [(5 * 10**8, 2 * 10**9)],
              "setup.capture": [(3 * 10**9, 6 * 10**9)], "setup.library": [(4 * 10**9, 5 * 10**9)]}
    monkeypatch.setattr(program, "spans", lambda name: record.get(name, []))
    ctx = _ctx(_ops(2), 2)
    got = {n: spec.metric_reader(n).read(ctx) for n in NEW}
    assert got == pytest.approx({"sampling_ms": 0.009, "bounce_ms": 0.009, "bind_host_ms": 0.15,
                                 "replay_host_ms": 2.0, "setup_scene_s": 2.0,
                                 "setup_library_s": 1.0, "setup_capture_s": 2.0})
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[stages]")]
    assert len(lines) == 1 and "replays=2 nodes=6 unstaged_pct=0.0" in lines[0]


def test_a_mismatch_is_one_stages_line_and_no_reading(monkeypatch, capsys):
    entry = types.SimpleNamespace(nodes=6, stages=STAGES, bind_ops=2, clone_ops=1)
    monkeypatch.setattr(program, "entry", lambda traffic: entry)
    ctx = _ctx(_ops(2)[:-1], 2)
    assert spec.metric_reader("sampling_ms").read(ctx) is None
    assert spec.metric_reader("bounce_ms").read(ctx) is None
    out = capsys.readouterr().out
    assert out.count("[stages] none: count mismatch") == 1


def test_every_new_reader_is_none_on_a_cpu_run(tiny_run):
    rc, result, out, err = tiny_run("colonnade.path_1080p", 1)
    assert rc == 0, err
    assert not set(NEW) & set(result["metrics"])
    assert "[stages] none: no stage map" in out
    ctx = _ctx([], 0)
    assert all(spec.metric_reader(n).read(ctx) is None for n in NEW)
