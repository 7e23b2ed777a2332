"""Set-up: host seconds in the port's ``rt.setup.library`` spans
(``kernels/build.py load``: the kernel library's build, where the checkout
has none, and its load)."""

from rtbench import program


def read(ctx):
    if program.entry(ctx.traffic) is None:
        return None
    found = program.spans("setup.library")
    return program.union_s(found) if found else None
