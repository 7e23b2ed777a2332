"""Frame dispatch (``render/compiled.py``, ``render/pipeline.py``
``compiled_*``): the median host milliseconds from the entry's call to
its return (binding the inputs, the graph's replay, the output's clone),
from the harness's ``rtbench.call`` span timed by the host clock on the
traced run's frames outside the profiled stretch."""

import statistics


def read(ctx):
    return statistics.median(ctx.dispatch_ms) if ctx.dispatch_ms else None
