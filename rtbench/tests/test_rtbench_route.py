"""The cell of a scene past the resident tables, ``colonnade2m.primary_1080p``:
its camera lap, its readers (``setup_paging_s``; ``cast_roofline_pct`` on K4)
and its tiny run through the port's big-scene route on the CPU.

The route takes a scene whose triangle rows reach the port's
``kernels/traversal.py PAGING_ROWS`` (2,097,152), past what the CPU
holds in a test; the tiny run lowers it below the tiny scene's rows, as
the port's own tests do, so the run compiles page tables and casts
through K4's plain version."""

import types

import numpy as np
import pytest

from rtbench import pose, program, scenes, spec
from rtbench.trace import Trace

CELL = "colonnade2m.primary_1080p"
ROUTED_ROWS = 64  # the lowered PAGING_ROWS: below the tiny scene's rows


def test_the_lap_clears_every_column_of_the_hall():
    config = spec.Cell(CELL).config
    v0, v1, v2 = scenes.colonnade(**config["args"])
    assert len(v0) == config["triangles"]
    # each column's own triangles after the floor's two, as the generator lays them
    columns = config["args"]["columns_x"] * config["args"]["columns_y"]
    corners = np.stack([v0[2:], v1[2:], v2[2:]], 1).reshape(columns, -1, 3)[..., :2]
    lo, hi = corners.min(1), corners.max(1)
    centre = (lo + hi) / 2
    radius = np.linalg.norm(corners - centre[:, None], axis=-1).max(1)
    cam = config["camera"]
    table = pose.lap(cam["center"], cam["height"], cam["forward"], cam["yaw_step"])
    assert len(table) == 628
    assert np.all(np.abs(np.hypot(table[:, 0] - 25.0, table[:, 1] - 25.0) - 5.0) < 0.01)
    gap = np.hypot(table[:, None, 0] - centre[None, :, 0],
                   table[:, None, 1] - centre[None, :, 1]) - radius[None, :]
    assert gap.min() >= 0.13


def test_setup_paging_s_reads_the_paging_spans(monkeypatch):
    reader = spec.metric_reader("setup_paging_s")
    monkeypatch.setattr(program, "entry", lambda traffic: object())
    record = {"setup.compile": [(0, 4 * 10**9)], "setup.paging": [(10**9, 3 * 10**9)]}
    monkeypatch.setattr(program, "spans", lambda name: record.get(name, []))
    ctx = types.SimpleNamespace(traffic={"entry": "image"})
    assert reader.read(ctx) == pytest.approx(2.0)
    del record["setup.paging"]  # a resident scene opens none
    assert reader.read(ctx) is None
    record["setup.paging"] = [(10**9, 3 * 10**9)]
    monkeypatch.setattr(program, "entry", lambda traffic: None)  # no captured entry
    assert reader.read(ctx) is None


class _Trace:
    ms_per_frame = Trace.ms_per_frame

    def __init__(self, kernels, frames):
        self.kernels, self.frames = kernels, frames


def test_cast_roofline_pct_reads_the_routed_casts():
    reader = spec.metric_reader("cast_roofline_pct")
    least = reader.least_ms(1920, 1080, 2163202)
    routed = [("void (anonymous namespace)::paged_wide_kernel<true>(Scene)", 0.0, 800.0),
              ("frame_attrs_kernel", 0.0, 100.0)] * 2
    traffic = {"entry": "image", "width": 1920, "height": 1080}
    ctx = types.SimpleNamespace(trace=_Trace(routed, 2), traffic=traffic, triangles=2163202)
    assert reader.read(ctx) == pytest.approx(100.0 * least / 0.8)
    assert 0 < reader.read(ctx) < 100
    assert "cast_roofline_pct" in [m["name"] for m in spec.Cell(CELL).per_layer]


def test_the_tiny_cell_on_the_route_is_correct(tiny_run, monkeypatch):
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.utils import profiling

    monkeypatch.setattr(traversal, "PAGING_ROWS", ROUTED_ROWS)
    profiling.clear()
    rc, result, out, err = tiny_run(CELL, 0)
    assert rc == 0, err
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    paging = [s for s in profiling.spans() if s.name == "setup.paging"]
    assert len(paging) == 1 and paging[0].parent == "setup.compile"
    assert paging[0].info["rows"] >= ROUTED_ROWS and paging[0].info["pages"] >= 1
