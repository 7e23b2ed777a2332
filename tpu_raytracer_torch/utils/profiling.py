"""The port's tracing: host spans, the stage map of each captured frame,
and ``trace`` for operators.

Tracing is on while a ``torch.profiler`` session runs (the flag
``torch.autograd.profiler._is_profiler_enabled``), and off otherwise;
there is no other switch. ``trace`` starts such a session, and so does
any ``torch.profiler.profile`` around the port's calls.

  * ``span(name)``: a host span. With tracing off it returns one shared
    null context after one flag read, and records nothing. With tracing
    on it opens ``record_function("rt.<name>")``, so the span lands in
    the profiler's trace on the clock of the device activity, and on exit
    appends a ``Span`` (name, frame, parent, start and end in
    ``perf_counter_ns``, info) to a bounded in-memory record
    (``MAX_SPANS``, the oldest dropped first): ``spans()`` returns it,
    ``clear()`` empties it. ``frame`` is the compiled entry's frame index,
    inherited from the enclosing span; ``parent`` is the enclosing span's
    name. The frame span's trace name carries its index
    (``rt.frame.<n>``), and its children nest inside it.
  * ``stage(name)``: a stage of a frame's body (``raygen``, ``cast``,
    ``attrs``, ``sample``, ``bounce``, ``light``, ``shade``, ``output``). In eager
    code it is a ``span``. While ``render/compiled.py`` captures a body
    into a CUDA graph (``StageMap``), each stage also records the count of
    device operations (kernel, memcpy and memset nodes) the capture holds
    at its entry and exit. A replay runs no Python, so no span marks it;
    but the capture runs on one stream, so its graph is a chain and the
    k-th device operation of every replay is node k: the entry's
    ``stages`` list of ``(name, first_node, end_node)``, in the order the
    stages were entered, attributes each replayed operation to its
    innermost stage. Nothing is added to the graph, so a replay costs the
    same with tracing on or off.
  * ``setup(name)``: a set-up span (``setup.bvh``, ``setup.optimize``,
    ``setup.compile``, ``setup.paging``, ``setup.library``,
    ``setup.capture``), recorded whether or not a profiler runs; each
    runs once per mesh, scene, library or entry. It also serves as a
    decorator.
  * ``trace(log_dir)``: a ``torch.profiler`` capture written as a trace
    that Perfetto or TensorBoard opens, holding the ``rt.*`` spans.

The spans and what reads them:

  * ``frame`` (``CompiledFrame.__call__``), its children ``bind``
    (``FrameEntry.bind``: the inputs copied in), ``replay`` (the graph's
    launch) and ``clone`` (the outputs' copy);
  * the stages, inside a frame's body (``render/pipeline.py``,
    ``render/integrators.py``, ``utils/prng.py``);
  * ``setup.bvh`` (``scene/mesh.py build_mesh_bvh``; info
    ``cache_hit``, ``opt_rounds``, ``triangles`` and the tree's ``sah``,
    on a build and on a cache hit alike), ``setup.optimize`` (the
    reinsertion optimizer, ``accel/optimize.py``, inside ``setup.bvh`` on
    a build with ``opt_rounds``; info ``rounds``, ``rounds_kept``,
    ``sah_before``, ``sah_after``), ``setup.compile`` (``Scene.compile``;
    info ``wide_sah`` and ``wide_triangles`` per mesh where it builds
    4-wide tables, ``kernels/wide4.py wide_sah``),
    ``setup.paging`` (``SceneTensors.with_paging``, the page tables'
    host build: inside ``setup.compile`` for a scene that needs paging;
    info ``pages``, ``rows``, ``bytes``),
    ``setup.library`` (``kernels/build.py load``; info ``kind``),
    ``setup.capture`` (``FrameEntry._capture``, whose duration is the
    entry's ``capture_s``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 100_000


class Span(NamedTuple):
    name: str
    frame: int | None
    parent: str | None
    t0_ns: int
    t1_ns: int
    info: dict | None = None


_RECORD: collections.deque = collections.deque(maxlen=MAX_SPANS)
_NULL = contextlib.nullcontext()
_local = threading.local()  # .stack: the open spans; .capture: the StageMap


def spans() -> list:
    """The recorded spans, oldest first (a span is recorded on exit, so a
    child comes before its parent)."""
    return list(_RECORD)


def clear() -> None:
    _RECORD.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open(contextlib.ContextDecorator):
    """A span in progress; ``seconds`` once it has closed."""

    def __init__(self, name: str, frame: int | None = None):
        self.name, self.frame, self.info = name, frame, None
        self._rf = None

    def _recreate_cm(self):  # a fresh span for each decorated call
        return type(self)(self.name, self.frame)

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.frame is None and outer is not None:
            self.frame = outer.frame
        stack.append(self)
        if _profiler._is_profiler_enabled:
            label = f"rt.frame.{self.frame}" if self.name == "frame" else "rt." + self.name
            self._rf = torch.profiler.record_function(label)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        _RECORD.append(Span(self.name, self.frame, self.parent, self.t0, self.t1, self.info))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str, frame: int | None = None):
    """A host span (module docstring); ``frame`` sets the frame index of
    it and the spans inside it."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, frame)


def setup(name: str) -> _Open:
    """The set-up span ``setup.<name>``, recorded with or without a
    profiler; set ``.info`` to a dict to record more."""
    return _Open("setup." + name)


class _Stage(_Open):
    def __enter__(self):
        self._map = getattr(_local, "capture", None)
        if self._map is not None:
            self._slot = self._map.open(self.name)
        self._traced = _profiler._is_profiler_enabled
        return super().__enter__() if self._traced else self

    def __exit__(self, *exc):
        if self._map is not None:
            self._map.close(self._slot)
        return super().__exit__(*exc) if self._traced else False


def stage(name: str):
    """A stage of a frame's body (module docstring)."""
    if getattr(_local, "capture", None) is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Stage(name)


class StageMap:
    """The stages of one capture: while it is entered on the capturing
    thread, each ``stage`` records ``count()``, the device operations the
    capture holds, at its entry and exit into ``stages``, as
    ``(name, first_node, end_node)`` in the order the stages were entered
    (a stage nested in another comes after it)."""

    def __init__(self, count):
        self.count = count
        self.stages: list = []

    def open(self, name: str) -> int:
        self.stages.append((name, self.count(), None))
        return len(self.stages) - 1

    def close(self, slot: int) -> None:
        name, first, _ = self.stages[slot]
        self.stages[slot] = (name, first, self.count())

    def __enter__(self):
        _local.capture = self
        return self

    def __exit__(self, *exc):
        _local.capture = None
        return False


def capture_counter(stream: torch.cuda.Stream):
    """``count()`` for a ``StageMap``: the kernel, memcpy and memset nodes
    of the graph being captured on ``stream`` (the kernel library's
    ``capture_device_ops``, which raises where the stream is not
    capturing)."""
    from ..kernels.build import launch

    out = ctypes.c_int64()

    def count() -> int:
        launch("capture_device_ops", ctypes.byref(out), stream=stream)
        return out.value

    return count


@contextlib.contextmanager
def trace(log_dir: str | None = None, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed renders into
    ``log_dir`` (default ``tpu_raytracer_torch_trace`` in the temporary
    directory) and yield ``log_dir``. On a CUDA ``device`` the trace
    records CPU and CUDA activity, on the CPU the CPU's alone; the port's
    ``rt.*`` spans are in it. The file is
    ``<host>_<pid>.<time>.pt.trace.json``: open it in Perfetto
    (ui.perfetto.dev) or with ``tensorboard --logdir <log_dir>``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "tpu_raytracer_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
