"""Device ms per replay in the frame's ``sample`` stage: the random draws
(``utils/prng.py`` ``split``, ``fold_in``, ``uniform``: threefry as int64
PyTorch ops) and ``render/integrators.py _cosine_sample``. Read from the
replays in the trace by their position in the captured graph
(``rtbench/program.py``): node k of a replay goes to its innermost stage."""

from rtbench import program


def read(ctx):
    return program.stage_reading(ctx, "sample")
