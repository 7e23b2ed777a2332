"""The Whitted frame's casts against the least time any implementation of
it must take, in percent: ``cast_roofline_pct.least_ms`` of the frame's
W x H primary rays (their inputs and nearest-hit outputs) and every stored
triangle once, over the device ms of the cast kernels (``cast_ms``'s
patterns, which name K3's ``tlas_traverse*``: nearest and any hit, every
bounce). It counts no secondary or shadow ray, so it reads the same work
whatever a change does to parking or compaction, and cannot pass 100."""

from rtbench.spec import metric_reader


def read(ctx):
    if ctx.traffic["entry"] != "whitted":
        return None
    ms = ctx.trace.ms_per_frame(metric_reader("cast_ms").PATTERNS)
    if ms <= 0:
        return None
    least = metric_reader("cast_roofline_pct").least_ms
    return 100.0 * least(ctx.traffic["width"], ctx.traffic["height"], ctx.triangles) / ms
