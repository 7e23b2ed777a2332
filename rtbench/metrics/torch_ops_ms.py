"""Device ms per frame in PyTorch's own kernels and copies: the stages
left to PyTorch ops (``render/integrators.py``, ``render/shade.py``,
``utils/prng.py``), and the graph's copies and fills."""

PATTERNS = ("at::native", "at_cuda_detail", "cub::", "elementwise_kernel_with_index", "memcpy",
            "memset")


def read(ctx):
    return ctx.trace.ms_per_frame(PATTERNS) if ctx.trace.kernels else None
