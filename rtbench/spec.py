"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
checkout's root, and under ``rtbench/`` one file per configuration
(``configs/<name>.json``, named by ``BENCHMARK.json``), per traffic mix
(``traffic/<name>.json``), per cell (``workloads/<name>.json``: the
limits of its output check), per per-layer metric (``metrics/<name>.py``:
a reader), per entry (``entries/<name>.py``: how a traffic's ``entry``
drives the port and draws its reference) and per scene generator beyond
the frozen ones (``generators/<name>.py``). Adding any of them adds files
and ``BENCHMARK.json`` entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


class Cell:
    """One cell of ``BENCHMARK.json`` with everything it reads: its
    configuration, traffic, check limits and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        bench = benchmark(root)
        self.root = root
        self.entry = _named(bench["workloads"], name, "workload")
        self.name = name
        self.chips = self.entry["chips"]
        self.config = _json(os.path.join(root, _named(bench["configs"], self.entry["config"],
                                                      "configuration")["file"]))
        self.traffic = _json(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "workloads", name + ".json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``rtbench/``; raises
    FileNotFoundError naming the file where there is none."""
    path = os.path.join(HERE, folder, name + ".py")
    if not NAME.match(name) or not os.path.isfile(path):
        raise FileNotFoundError(f"{name!r} is not in rtbench/{folder}/: no file {path}")
    spec = importlib.util.spec_from_file_location(f"rtbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(ctx)`` returns the metric's
    value, or None where it finds nothing to read; ``PATTERNS``, where it
    has them, are the kernel-name parts it claims."""
    return module("metrics", name)


def entry(name: str):
    """The module ``entries/<name>.py`` of a traffic's ``entry``:

      * ``KEYED``: whether a frame takes a key;
      * ``COMPILED`` (optional): the name of the compiled entry point of
        the port's ``render/pipeline.py`` whose ``last`` entry holds the
        stage map (``program.py``);
      * ``bind(pipeline, scene, cfg, traffic)`` -> ``frame(K_inv, D,
        pose, inv_pose, key)``, the u8 image on the scene's device;
      * ``reference(ref, rays, key, config, traffic)`` -> the reference's
        u8 frame (``ref`` a ``check.Reference``: ``geom``, ``scene``).
    """
    return module("entries", name)


def all_metric_readers() -> dict:
    """Every reader under ``metrics/``, by name."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                   if f.endswith(".py") and not f.startswith("_"))
    return {n: metric_reader(n) for n in names}
