"""The device's idle share of the traced window, in percent: 1 - (the
union of its kernel, memcpy and memset intervals) / (the window), both
from one trace."""


def read(ctx):
    t = ctx.trace
    if not t.device_ops or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
