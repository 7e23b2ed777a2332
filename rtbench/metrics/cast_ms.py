"""Device ms per frame in the cast kernels (``kernels/traversal.py``,
``binary.py``, ``tlas.py``, ``paged.py``, ``paged_major.py`` ->
``kernels/csrc/*traverse*.cu``, ``paged_major.cu``, ``page_plan.cu``)."""

PATTERNS = ("traverse", "paged_wide_kernel", "paged_binary_kernel", "paged_major_kernel",
            "page_plan_")


def read(ctx):
    ms = ctx.trace.ms_per_frame(PATTERNS)
    return ms if ms > 0 else None
