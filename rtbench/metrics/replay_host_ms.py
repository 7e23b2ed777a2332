"""Frame dispatch: the median host ms of the port's ``rt.replay`` span
(``render/compiled.py FrameEntry.run``: the CUDA graph's launch), over the
traced frames: the span is recorded only while the profiler runs, so this
is read under the profiler, as ``device_idle_pct`` is."""

from rtbench import program


def read(ctx):
    return program.host_ms(ctx, "replay")
