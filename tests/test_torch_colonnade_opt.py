"""Config 5 on its optimized tree through the benchmark's harness, at the
tiny size of its ``colonnade_opt`` configuration (``procgen.colonnade(4,
4, 8, 4)``, 1,026 triangles, BVH after ``opt_rounds`` 2) on the CPU: a run
of the cell ``colonnade_opt.path_1080p`` (``rtbench.run.main(device=
"cpu")``, 48 x 32) is ``correct`` against ``rtbench/reference.py``, its
set-up ran the optimizer inside the BVH build, and a traced run's
``tree_sah`` is the optimized tree's ``sah_cost``.

Each run is a process of its own: the harness refuses a result where the
JAX package is loaded, as other test files here load it."""

import json
import os
import subprocess
import sys

import pytest

from tpu_raytracer_torch.accel.bvh import sah_cost
from tpu_raytracer_torch.scene import procgen
from tpu_raytracer_torch.scene.mesh import MeshPrimitive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "colonnade_opt.path_1080p"

RUN = """
import json, sys
from rtbench import run, spec
from tpu_raytracer_torch.utils import profiling
cell = spec.Cell({cell!r})
cell.traffic.update(width=48, height=32, check_within=4, trace_start=2, trace_frames=2)
for key in ("args", "camera"):
    cell.config[key].update(cell.config["tiny"].get(key, {{}}))
rc = run.main(["--workload", {cell!r}, "--seed", "2147483725", "--seconds", "0.3",
               "--trace", "{trace}"], device="cpu", cell=cell)
setup = [[s.name, s.parent, s.info] for s in profiling.spans() if s.name.startswith("setup.")]
print("SETUP " + json.dumps(setup))
sys.exit(rc)
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_renders_correct_on_the_optimized_tree(trace):
    r = subprocess.run([sys.executable, "-c", RUN.format(cell=CELL, trace=trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    setup = json.loads(lines[-1].split("SETUP ", 1)[1])
    result = json.loads(lines[-2])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    tree = MeshPrimitive.from_triangles(*procgen.colonnade(4, 4, 8, 4), opt_rounds=2,
                                        cache_dir=False).bvh
    ((_, _, bvh),) = [s for s in setup if s[0] == "setup.bvh"]
    assert bvh == {"cache_hit": False, "opt_rounds": 2, "triangles": 1026,
                   "sah": sah_cost(tree)}
    ((_, parent, opt),) = [s for s in setup if s[0] == "setup.optimize"]
    assert parent == "setup.bvh" and opt["rounds"] == 2 and opt["sah_after"] == sah_cost(tree)
    if trace:
        assert result["metrics"]["tree_sah"]["value"] == pytest.approx(sah_cost(tree))
        assert result["metrics"]["wide_tree_sah"]["unit"] == "SAH"
    else:
        assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
