"""The port's own host acceleration code (``tpu_raytracer_torch/accel``)
against the JAX package's, and the port's independence from it.

The BVH builders (numpy and the native C++ builder, which the port
builds from its own source with g++), the 4-wide collapse and the page
cut must equal ``tpu_raytracer.accel``'s array for array on the same
seeded meshes: the port's triangle and node ids are the JAX package's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_raytracer.accel import native as jax_native
from tpu_raytracer.accel.bvh import build_bvh as jax_build_bvh
from tpu_raytracer.accel.paging import build_page_table as jax_page_table
from tpu_raytracer.accel.wide import collapse4 as jax_collapse4
from tpu_raytracer_torch.accel import native
from tpu_raytracer_torch.accel.bvh import build_bvh
from tpu_raytracer_torch.accel.paging import build_page_table
from tpu_raytracer_torch.accel.wide import collapse2, collapse4
from tpu_raytracer_torch.app.scenes import scene_colonnade
from tpu_raytracer_torch.scene import mesh, procgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BVH_FIELDS = ("node_min", "node_max", "child_a", "child_b", "leaf_start", "leaf_count", "order")


def seeded_mesh(seed: int):
    """A triangle soup (seeds 0-1) or the displaced blob (seed 2)."""
    if seed == 2:
        return procgen.blob(subdivisions=3, seed=5)
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4.0, 4.0, (3000, 1, 3)).astype(np.float32)
    v = (c + rng.normal(0.0, 0.2, (3000, 3, 3))).astype(np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def assert_same_bvh(a, b):
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("mode,min_leaf", [("sweep", 16), ("sweep", 1), ("reference", 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builders_match_jax(seed, mode, min_leaf):
    """The numpy builder in both modes (the sweep builds meshes, the
    reference search the TLAS) and the native builder, which builds the
    meshes' sweep tree only."""
    tris = seeded_mesh(seed)
    kw = dict(max_depth=48, min_leaf_size=min_leaf)
    want = jax_build_bvh(*tris, mode=mode, **kw)
    assert_same_bvh(build_bvh(*tris, mode=mode, **kw), want)
    if mode != "sweep":
        return
    assert_same_bvh(native.build_bvh_native(*tris, **kw), want)
    if jax_native.native_available():
        assert_same_bvh(native.build_bvh_native(*tris, **kw),
                        jax_native.build_bvh_native(*tris, mode="sweep", **kw))


def test_collapses_and_page_cut_match_jax():
    v0, v1, v2 = procgen.colonnade(3, 3, 8)
    b = build_bvh(v0, v1, v2, max_depth=48, min_leaf_size=16, mode="sweep")
    args = (b.child_a, b.child_b, b.leaf_start, b.leaf_count, b.node_min, b.node_max,
            np.array([0]))
    got, want = collapse4(*args), jax_collapse4(*args)
    for f in ("wcode", "wbox_min", "wbox_max", "wroot"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    # the page cut reads the compiled scene's 8-aligned leaf layout
    f = scene_colonnade(8, 8, columns=3, segs=8, device="cpu")[0].numpy_fields()
    pt_args = tuple(f[k] for k in ("node_min", "node_max", "node_child_a", "node_child_b",
                                   "node_leaf_start", "node_leaf_count", "mesh_root"))
    got, want = build_page_table(*pt_args, page_tris=64, page_nodes=32), \
        jax_page_table(*pt_args, page_tris=64, page_nodes=32)
    for f in ("top_code", "top_child_min", "top_child_max", "top_root", "page_node0",
              "page_tri0"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_collapse2_is_the_binary_tree_in_child_code_layout():
    """Every internal binary node is one arity-2 node (node order), its
    entries its two children; a single-leaf mesh gets one node."""
    v0, v1, v2 = procgen.icosphere(2)
    b = build_bvh(v0, v1, v2, max_depth=48, min_leaf_size=4, mode="sweep")
    n = len(b.child_a)
    # a second, single-leaf mesh appended after the first
    child_a = np.append(b.child_a, -1)
    child_b = np.append(b.child_b, -1)
    leaf_start = np.append(b.leaf_start, 7)
    leaf_count = np.append(b.leaf_count, 3)
    node_min = np.vstack([b.node_min, [[0, 0, 0]]]).astype(np.float32)
    node_max = np.vstack([b.node_max, [[1, 1, 1]]]).astype(np.float32)
    w = collapse2(child_a, child_b, leaf_start, leaf_count, node_min, node_max,
                  np.array([0, n]))
    inner = np.nonzero(child_a >= 0)[0]
    assert w.num_nodes == len(inner) + 1
    assert w.wroot.tolist() == [0, len(inner)]
    code = w.wcode.reshape(-1, 2)
    for wid, node in enumerate(inner):
        for c, child in enumerate((child_a[node], child_b[node])):
            if child_a[child] >= 0:
                assert inner[code[wid, c]] == child
            else:
                assert code[wid, c] == -(leaf_start[child] * 1024 + leaf_count[child]) - 1
            np.testing.assert_array_equal(w.wbox_min[wid, c], node_min[child])
    assert code[-1].tolist() == [-(7 * 1024 + 3) - 1, -1]
    assert (w.wbox_min[-1, 1] > w.wbox_max[-1, 1]).all()  # absent: inverted box


def test_big_meshes_use_the_native_builder_and_raise_when_it_fails(monkeypatch):
    tris = seeded_mesh(0)
    built = mesh.MeshPrimitive.from_triangles(*tris)
    want = build_bvh(*tris, max_depth=mesh.MAX_DEPTH, min_leaf_size=mesh.MIN_LEAF_SIZE,
                     mode="sweep")
    assert_same_bvh(built.bvh, want)

    def broken():
        raise RuntimeError("building libbvh_builder.so failed: g++: error")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr("tpu_raytracer_torch.kernels.build.build_bvh_builder", broken)
    big = tuple(np.tile(v, (2, 1)) for v in tris)  # 6000 >= _NATIVE_MIN_TRIS
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        mesh.MeshPrimitive.from_triangles(*big)
    small = tuple(v[:100] for v in tris)
    mesh.MeshPrimitive.from_triangles(*small)  # numpy below the threshold


def test_port_imports_nothing_of_jax_or_the_jax_package(tmp_path):
    """Every module of the port imports with ``jax`` and
    ``tpu_raytracer`` blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_raytracer'] = None\n"
        "import tpu_raytracer_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpu_raytracer_torch.__path__,\n"
        "                                              'tpu_raytracer_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 25, names\n"
        "new = {'tpu_raytracer_torch.' + m for m in ('kernels.binary', 'utils.prng',\n"
        "       'render.denoise', 'render.sorted_cast', 'app.controls', 'accel.presplit',\n"
        "       'accel.optimize', 'scene.cache', 'scene.native_obj', 'parallel.group',\n"
        "       'parallel.sharding', 'parallel.scene_shard', 'parallel.dryrun',\n"
        "       'app.interactive', 'app.web', 'utils.profiling', 'bench_all', 'bench_paged')}\n"
        "assert new <= set(names), new - set(names)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
