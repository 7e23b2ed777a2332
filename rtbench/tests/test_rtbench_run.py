"""A run end to end at a tiny size on the CPU: its result line, its
refusals, and the modules it loads."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from rtbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contracts_keys(tiny_run, cell, trace):
    rc, result, out, err = tiny_run(cell, trace)
    assert rc == 0, err
    assert list(result)[-1] == "checks"
    want = KEYS + (["breakdown"] if trace else [])
    assert [k for k in result if k != "checks"] == want
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    c = spec.Cell(cell)
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the numbers compared: the last lines of standard error and the last key
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(result["checks"])
    for k, v in result["checks"].items():
        assert set(v) == {"value", "limit"}


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_a_tiny_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'rtbench/tests'); import conftest, json\n"
            "from rtbench import run\n"
            "rc = run.main(['--workload', 'colonnade.path_1080p', '--seed', '5', '--seconds',"
            " '0.2', '--trace', '1'], device='cpu', cell=conftest.tiny_cell('colonnade.path_1080p'))\n"
            "assert rc == 0\n"
            "top = sorted({m.split('.')[0] for m in sys.modules})\n"
            "print('TOP', json.dumps(top))\n")
    r = _python(code, ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(__import__("json").loads(r.stdout.split("TOP ")[-1]))
    assert "tpu_raytracer_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tpu_raytracer"}, top


def test_the_forbidden_names_are_whole_top_level_names(monkeypatch):
    from rtbench import run

    monkeypatch.setitem(sys.modules, "tpu_raytracer_torch_x", sys)
    assert "tpu_raytracer" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_raytracer.core", sys)
    assert "tpu_raytracer" in run.forbidden_modules()


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "rtbench", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_port_in_the_checkout_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from rtbench import run\n"
            "import sys; sys.exit(run.main(['--workload', 'bunny.primary_1080p', '--seed', '1',"
            " '--seconds', '0.2'], device='cpu'))\n")
    r = _python(code, str(tmp_path), env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and '"correct"' not in r.stdout
