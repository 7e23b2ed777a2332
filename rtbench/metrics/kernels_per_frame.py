"""Device kernels a frame launches, from the trace: the launches the
stages left to PyTorch ops (``render/integrators.py``,
``render/shade.py``, ``utils/prng.py``) add, beside the port's own
kernels."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.trace.frames if ctx.trace.kernels else None
