"""Set-up: host seconds in the port's ``rt.setup.paging`` spans
(``scene/scene.py SceneTensors.with_paging``: the host build of the page
tables, ``kernels/paged.py prepare_paged``; inside ``rt.setup.compile``,
which ``setup_scene_s`` reads whole). Only a scene that needs paging opens
one, so a resident cell reads nothing."""

from rtbench import program


def read(ctx):
    if program.entry(ctx.traffic) is None:
        return None
    found = program.spans("setup.paging")
    return program.union_s(found) if found else None
