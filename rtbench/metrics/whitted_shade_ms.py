"""Device ms per replay in the Whitted frame's ``shade`` stage, innermost:
the rest of ``render/integrators.py render_whitted``'s bounce (the sky,
``surface_color``'s albedo and texel lookups, the radiance and throughput
sums, the reflected rays and their parking). Read from the replays in the
trace by their position in the captured graph (``rtbench/program.py``)."""

from rtbench import program


def read(ctx):
    return program.stage_reading(ctx, "shade")
