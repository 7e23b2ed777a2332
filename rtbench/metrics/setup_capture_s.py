"""Set-up: the self time in host seconds of the port's ``rt.setup.capture``
spans (``render/compiled.py FrameEntry._capture``: the eager warm-up and
the CUDA graph's capture), less the ``rt.setup.library`` spans inside them
(the first warm-up loads the kernel library)."""

from rtbench import program


def read(ctx):
    if program.entry(ctx.traffic) is None:
        return None
    captures = program.spans("setup.capture")
    if not captures:
        return None
    libraries = program.spans("setup.library")
    inside = [(max(s, c0), min(e, c1)) for c0, c1 in captures for s, e in libraries
              if s < c1 and e > c0]
    return program.union_s(captures) - program.union_s(inside)
