"""Device ms per replay in the frame's ``bounce`` stage: the path tracer's
bounce arithmetic (``render/integrators.py`` ``bounce_from_attrs``,
``run_bounces``) and AO's accumulation, less the casts and samples inside
it. Read from the replays in the trace by their position in the captured
graph (``rtbench/program.py``)."""

from rtbench import program


def read(ctx):
    return program.stage_reading(ctx, "bounce")
