"""Device ms per replay in the Whitted frame's ``light`` stage, innermost:
``render/integrators.py _direct_illumination`` at each bounce (the
directional light's cosine, the shadow rays' origins and their parking),
less its any-hit casts, which are stage ``cast``. Read from the replays in
the trace by their position in the captured graph (``rtbench/program.py``)."""

from rtbench import program


def read(ctx):
    return program.stage_reading(ctx, "light")
