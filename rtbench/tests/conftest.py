"""A run of a cell at a size the CPU holds: the cell's files with the
frame cut to 48 x 32 and the scene to a few hundred triangles, on the
CPU (``run.main(device="cpu")`` skips the look for a card)."""

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
    if cell.config["generator"] == "blob":
        cell.config["args"]["subdivisions"] = 2
    else:
        cell.config["args"].update(columns_x=4, columns_y=4, segs=8, bands=4)
        cell.config["camera"].update(center=[5.0, 5.0], height=0.6, forward=0.2, yaw_step=0.1)
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
