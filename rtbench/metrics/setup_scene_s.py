"""Set-up: host seconds in the port's ``rt.setup.bvh`` (``scene/mesh.py
build_mesh_bvh``: the BVH from its cache, or built) and ``rt.setup.compile``
(``Scene.compile``) spans, an interval inside another counted once."""

from rtbench import program


def read(ctx):
    if program.entry(ctx.traffic) is None:
        return None
    found = program.spans("setup.bvh") + program.spans("setup.compile")
    return program.union_s(found) if found else None
