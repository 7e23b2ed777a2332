"""Profiling and frame-rate instrumentation (counterpart of
``tpu_raytracer/utils/profiling.py``).

The reference's profiling surface is wall-clock FPS via cv::getTickCount
(kernel.cu:275-293) plus an out-of-band Nsight Compute capture. Here:

  * ``FrameTimer``: per-frame FPS and Mrays/s counters. On a CUDA device
    a frame is timed with CUDA events recorded at enter and exit and
    synchronized at exit, so the reading is the card's frame time, not
    the time to enqueue it; on the CPU with ``time.perf_counter``.
  * ``trace``: a ``torch.profiler`` capture written as a trace that
    TensorBoard (the PyTorch profiler plugin) or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed renders into
    ``log_dir`` (default ``tpu_raytracer_torch_trace`` in the temporary
    directory) and yield ``log_dir``. On a CUDA ``device`` the trace
    records CPU and CUDA activity, on the CPU the CPU's alone. The file is
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


class FrameTimer:
    """Rolling FPS / Mrays/s counter (kernel.cu:275-293 analog): each
    ``with timer:`` block is one frame."""

    def __init__(self, rays_per_frame: int, device="cuda"):
        self.rays_per_frame = rays_per_frame
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self.frames = 0
        self.total_s = 0.0
        self.last_fps = 0.0
        self._start = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        self.frames += 1
        self.total_s += dt
        self.last_fps = 1.0 / dt if dt > 0 else float("inf")
        return False

    @property
    def fps(self) -> float:
        return self.frames / self.total_s if self.total_s else 0.0

    @property
    def mrays_per_s(self) -> float:
        return self.fps * self.rays_per_frame / 1e6

    def summary(self) -> str:
        return f"{self.frames} frames, {self.fps:.2f} FPS, {self.mrays_per_s:.1f} Mrays/s"
