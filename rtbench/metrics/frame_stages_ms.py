"""Device ms per frame in the frame-stage kernels S1-S3
(``kernels/frame.py`` -> ``kernels/csrc/frame.cu``: raygen, hit
attributes, primary shade)."""

PATTERNS = ("frame_raygen_kernel", "frame_attrs_kernel", "frame_shade_kernel")


def read(ctx):
    ms = ctx.trace.ms_per_frame(PATTERNS)
    return ms if ms > 0 else None
