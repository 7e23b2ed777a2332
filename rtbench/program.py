"""What the port records of itself, for the per-layer readers: its spans
(``tpu_raytracer_torch.utils.profiling.spans()``) and the stage map of the
cell's compiled entry (``FrameEntry.stages`` and ``nodes``), read through
the port's public modules. The entry is the ``last`` of the compiled
entry point that the traffic's entry module names (``COMPILED`` in
``entries/<entry>.py``).

Every reader of this module reads only where the entry was captured as a
CUDA graph (it has ``nodes``): on the CPU, or with a port that records
none of this, each returns None and raises nothing.

Stages of a replay: a call of the entry runs ``bind_ops`` copies, its
graph's ``nodes`` device operations and ``clone_ops`` copies, in that
order on one stream. So the traced window's device operations, in start
order, split into calls of ``bind_ops + nodes + clone_ops``, and the k-th
operation of a replay is node k, which belongs to the innermost stage
whose ``[first_node, end_node)`` holds it (the map lists stages in the
order they were entered, so a nested stage comes after its outer one).
"""

from __future__ import annotations

import importlib
import json
import statistics

from . import spec
from .system import PORT


def _port(module: str):
    try:
        return importlib.import_module(f"{PORT}.{module}")
    except ImportError:
        return None


def entry(traffic: dict):
    """The cell's compiled entry if it was captured as a graph, else None."""
    pipeline = _port("render.pipeline")
    compiled = getattr(spec.entry(traffic["entry"]), "COMPILED", None)
    frame = getattr(pipeline, compiled, None) if compiled else None
    last = getattr(frame, "last", None)
    return last if getattr(last, "nodes", None) else None


def spans(name: str) -> list:
    """``(t0_ns, t1_ns)`` of every span ``name`` in the port's record."""
    profiling = _port("utils.profiling")
    if profiling is None or not hasattr(profiling, "spans"):
        return []
    return [(s.t0_ns, s.t1_ns) for s in profiling.spans() if s.name == name]


def union_s(intervals) -> float:
    """Seconds covered by ``(t0_ns, t1_ns)`` intervals, overlaps once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def host_ms(ctx, name: str):
    """Median ms of the span ``name`` over the traced frames (spans are
    recorded only while the profiler runs)."""
    if entry(ctx.traffic) is None:
        return None
    ms = [(t1 - t0) / 1e6 for t0, t1 in spans(name)]
    return statistics.median(ms) if ms else None


def innermost(stages, nodes: int) -> list:
    """The innermost stage of each node ``0..nodes``, None outside all."""
    labels = [None] * nodes
    for name, first, end in stages:
        for k in range(max(first, 0), min(end, nodes)):
            labels[k] = name
    return labels


def attribute(ops, frames: int, nodes: int, stages, bind_ops: int = 0, clone_ops: int = 0):
    """(ms per replay by stage, None for nodes in no stage; why) from
    ``ops``, (name, ts_us, dur_us, cat) device operations of ``frames``
    calls; the dict is None, and ``why`` says why, where they do not split
    into calls."""
    ops = sorted(ops, key=lambda d: d[1])
    per = bind_ops + nodes + clone_ops
    if not frames or len(ops) != frames * per:
        return None, (f"count mismatch: {len(ops)} traced device operations, not {frames} calls "
                      f"of {bind_ops} + {nodes} + {clone_ops}")
    copies = [op for c in range(frames) for op in
              ops[c * per:c * per + bind_ops] + ops[c * per + bind_ops + nodes:(c + 1) * per]]
    if any(op[3] != "gpu_memcpy" for op in copies):
        return None, "count mismatch: a call's bind or clone operations are not copies"
    labels = innermost(stages, nodes)
    ms: dict = {}
    for c in range(frames):
        base = c * per + bind_ops
        for k, label in enumerate(labels):
            ms[label] = ms.get(label, 0.0) + ops[base + k][2] / 1e3
    return {k: v / frames for k, v in ms.items()}, ""


def stage_ms(ctx):
    """Device ms per replay by innermost stage (``attribute``) for the
    traced window, once a run (kept on ``ctx``); prints one ``[stages]``
    line."""
    if not hasattr(ctx, "stage_ms"):
        e = entry(ctx.traffic)
        if e is None:
            ms, why = None, "no stage map: the entry was not captured as a CUDA graph"
        else:
            ms, why = attribute(ctx.trace.device_ops, ctx.trace.frames, e.nodes, e.stages,
                                e.bind_ops, e.clone_ops)
        if ms is None:
            print(f"[stages] none: {why}", flush=True)
        else:
            total = sum(ms.values())
            print(f"[stages] replays={ctx.trace.frames} nodes={e.nodes} "
                  f"unstaged_pct={100.0 * ms.get(None, 0.0) / total if total else 0.0!r} "
                  "ms_per_replay=" + json.dumps({str(k): v for k, v in ms.items()}), flush=True)
        ctx.stage_ms = ms
    return ctx.stage_ms


def stage_reading(ctx, name: str):
    ms = stage_ms(ctx)
    return ms.get(name) if ms else None
