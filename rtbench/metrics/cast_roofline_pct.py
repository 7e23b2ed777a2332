"""The casts' share of their least time, in percent: the bytes a primary
frame's cast needs, whatever walks the tree, over the H100's published
HBM bandwidth (3.35 TB/s, SXM, at a 700 W power limit; the run prints
the card's limit beside it), against the device ms of the cast kernels
(``cast_ms``'s patterns). The bytes: each of the W x H rays' origin and
direction read once (24 B), its t, triangle, instance and normal written
once (24 B), and every triangle read once (36 B). Read only where a frame
casts exactly W x H rays (the primary entry)."""

from rtbench.spec import metric_reader

HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 24 + 24
TRIANGLE_BYTES = 36


def least_ms(width: int, height: int, triangles: int) -> float:
    return (width * height * RAY_BYTES + triangles * TRIANGLE_BYTES) / HBM_BYTES_PER_S * 1e3


def read(ctx):
    if ctx.traffic["entry"] != "image":
        return None
    ms = ctx.trace.ms_per_frame(metric_reader("cast_ms").PATTERNS)
    if ms <= 0:
        return None
    return 100.0 * least_ms(ctx.traffic["width"], ctx.traffic["height"], ctx.triangles) / ms
