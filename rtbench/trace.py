"""The traced stretch of a ``--trace 1`` run, reduced to what the
per-layer readers read.

``Tracer`` profiles a steady stretch of the window with
``torch.profiler`` (CPU and CUDA activity); each frame's host phases
are spans of the harness (``record_function``: ``rtbench.pose``, the
camera and key, ``rtbench.call``, the entry's call to its return, and
``rtbench.sync``, the wait for the card). The trace is exported once to
a fixed file in the checkout's cache and read back:

  * the traced window runs from the first frame's ``rtbench.pose`` to the
    last frame's ``rtbench.sync`` end;
  * device activity is every kernel, memcpy and memset in it; ``busy_us``
    is the length of their union;
  * ``Trace.ms_per_frame(patterns)`` sums the device time of kernels whose
    name holds any of ``patterns``, per traced frame;
  * ``breakdown()`` lists the device operations that took the most time,
    and the longest idle gaps, each labelled by the innermost span the
    host was in at its middle: one of the port's ``rt.*`` spans where
    one holds it (``rt.frame.<n>`` as ``rt.frame``), else the harness
    span, else ``between_spans``.
"""

from __future__ import annotations

import bisect
import json
import os
import re

SPANS = ("rtbench.pose", "rtbench.call", "rtbench.sync")
PROGRAM = "rt."  # the port's spans (tpu_raytracer_torch/utils/profiling.py)
FRAME_INDEX = re.compile(r"^(rt\.frame)\.\d+$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """A ``torch.profiler`` run over frames [start, start + count)."""

    def __init__(self, start: int, count: int, path: str):
        self.start, self.stop, self.path = start, start + count, path
        self.prof = None
        self.frames = 0

    def before(self, frame: int) -> None:
        if frame == self.start:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def after(self, frame: int) -> None:
        if self.prof is not None and frame + 1 == self.stop:
            self.close(frame + 1 - self.start)

    def close(self, frames: int) -> None:
        if self.prof is None or self.frames:
            return
        self.prof.__exit__(None, None, None)
        self.frames = frames
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def active(self, frame: int) -> bool:
        return self.start <= frame < self.stop


def _union(intervals):
    """Sorted disjoint (start, end) of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The traced window of one run: device activity, harness spans and
    the frame count."""

    def __init__(self, path: str, frames: int):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") in SPANS and "dur" in e]
        if not spans or not frames:
            raise RuntimeError("the trace holds none of the harness's frame spans")
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in spans)
        self._starts = [s[0] for s in self.spans]
        self.t0 = self.spans[0][0]
        self.t1 = max(s[1] for s in self.spans)
        # by start, and of equal starts the outer (longer) first
        self.program_spans = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              FRAME_INDEX.sub(r"\1", e["name"])) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PROGRAM)
             and "dur" in e and self.t0 <= float(e["ts"]) < self.t1),
            key=lambda s: (s[0], -s[1]))
        self._program_starts = [s[0] for s in self.program_spans]
        self._program_longest = max((e - s for s, e, _ in self.program_spans), default=0.0)
        self.frames = frames
        dev = [(e.get("name", "?"), float(e["ts"]), float(e["dur"]), e["cat"]) for e in events
               if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.device_ops = [d for d in dev if self.t0 <= d[1] < self.t1]
        self.kernels = [(n, ts, dur) for n, ts, dur, cat in self.device_ops if cat == "kernel"]
        clipped = [(max(ts, self.t0), min(ts + dur, self.t1)) for _, ts, dur, _ in self.device_ops]
        self.busy = _union([c for c in clipped if c[1] > c[0]])
        self.busy_us = sum(e - s for s, e in self.busy)
        self.window_us = self.t1 - self.t0

    def ms_per_frame(self, patterns) -> float:
        us = sum(dur for name, _, dur in self.kernels if any(p in name for p in patterns))
        return us / self.frames / 1e3

    def unclaimed(self, patterns) -> dict:
        """Device ms per frame, by kernel name, in kernels that none of
        ``patterns`` claims."""
        out = {}
        for name, _, dur in self.kernels:
            if not any(p in name for p in patterns):
                out[name] = out.get(name, 0.0) + dur / self.frames / 1e3
        return out

    def _span_at(self, t: float) -> str:
        """The innermost span the host was in at ``t``: of the port's spans
        that hold it, the one that started last (they nest); else the
        harness span (those do not nest)."""
        i = bisect.bisect_right(self._program_starts, t) - 1
        while i >= 0 and self.program_spans[i][0] >= t - self._program_longest:
            if t < self.program_spans[i][1]:
                return self.program_spans[i][2]
            i -= 1
        i = bisect.bisect_right(self._starts, t) - 1
        return self.spans[i][2] if i >= 0 and t < self.spans[i][1] else "between_spans"

    def breakdown(self, n: int = 10) -> dict:
        by_name = {}
        for name, _, dur, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, prev = [], self.t0
        for s, e in self.busy + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((s - prev, self._span_at((s + prev) / 2)))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[label, us / 1e6] for us, label in gaps[:n]]}
