"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric it names is found by
name under rtbench/."""

import json
import os
import re

import pytest

from rtbench import spec

BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]


def test_names_and_units_keep_to_the_allowed_characters():
    names = list(_names())
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(spec.NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_and_its_files_are_found_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert set(c.limits) >= {"px_off_pct", "mean_abs"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert hasattr(spec.metric_reader(m["name"]), "read")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    path = os.path.join(spec.ROOT, config["file"])
    assert path.startswith(os.path.join(spec.ROOT, "rtbench") + os.sep)
    with open(path) as f:
        data = json.load(f)
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert {"generator", "args", "albedo", "camera", "fov_deg", "assumed"} <= set(data)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_metric_file_is_named_by_the_benchmark():
    on_disk = set(spec.all_metric_readers())
    assert on_disk == {m["name"] for m in BENCH["per_layer"]}
