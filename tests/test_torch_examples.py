"""The port's examples (``examples/torch/``) stay runnable: each compiles,
and each runs in a subprocess on the CPU at 64x64 (``--device cpu --size
64``; ``05_multichip`` on two gloo ranks), exits 0 and prints the path of
the PNG it wrote, which holds a 64x64 image that is not one colour."""

import os
import py_compile
import re
import subprocess
import sys

import pytest

from tpu_raytracer_torch.utils.image import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(ROOT, "examples", "torch")
EXAMPLES = sorted(f for f in os.listdir(DIR) if f.endswith(".py"))


def test_all_examples_compile():
    assert [f[:3] for f in EXAMPLES] == [f"{i:02d}_" for i in range(1, 7)]
    for f in EXAMPLES:
        py_compile.compile(os.path.join(DIR, f), doraise=True)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, tmp_path):
    extra = ["--world-size", "2"] if name.startswith("05") else []
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, os.path.join(DIR, name), "--device", "cpu", "--size",
                        "64", *extra], capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"(\S*example_torch_\w+\.png)", r.stdout)
    assert m, r.stdout
    assert os.path.dirname(m.group(1)) == str(tmp_path)
    img = read_png(m.group(1))
    assert img.shape == (64, 64, 3) and (img != img[0, 0]).any()
