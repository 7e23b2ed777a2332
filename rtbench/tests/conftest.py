"""A run of a cell at a size the CPU holds: the cell's files with the
frame cut to 48 x 32 and the scene to its configuration's ``tiny`` sizes
(``{"args": {...}, "camera": {...}}``, each merged over its key; a few
hundred triangles), on the CPU (``run.main(device="cpu")`` skips the
look for a card). A configuration without ``tiny`` runs at its own
size."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import run, spec  # noqa: E402

SEED = 2 ** 31 + 77


def tiny_cell(name: str):
    cell = spec.Cell(name)
    cell.traffic.update(width=48, height=32, check_within=4, trace_start=2, trace_frames=2)
    tiny = cell.config.get("tiny", {})
    for key in ("args", "camera"):
        cell.config[key].update(tiny.get(key, {}))
    return cell


@pytest.fixture
def tiny_run(capsys):
    """``tiny_run(cell, trace=0)`` -> (exit code, result dict or None,
    stdout, stderr)."""

    def go(name, trace=0, seed=SEED):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.3",
                       "--trace", str(trace)], device="cpu", cell=tiny_cell(name))
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        result = json.loads(lines[-1]) if rc == 0 else None
        return rc, result, out, err

    return go
