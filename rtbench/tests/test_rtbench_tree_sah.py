"""The ``colonnade_opt`` configuration (BASELINE config 5 on the tree
after two reinsertion rounds) and the tree's SAH readers: the generator
gives the frozen colonnade with ``opt_rounds`` 2 and the configuration's
albedo, the triangle count is the scene's, and ``tree_sah`` and
``wide_tree_sah`` read the port's set-up spans, None without their info."""

import numpy as np
import pytest

from rtbench import run, scenes, spec
from tpu_raytracer_torch.utils import profiling

CONFIG = spec.Cell("colonnade_opt.path_1080p").config


def test_the_generator_gives_the_frozen_colonnade_built_with_two_rounds():
    desc = scenes.scene(CONFIG)
    (mesh,) = desc["meshes"]
    for got, want in zip((mesh["v0"], mesh["v1"], mesh["v2"]), scenes.colonnade(10, 10, 32, 40)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert mesh["opt_rounds"] == 2 and set(mesh) == {"v0", "v1", "v2", "opt_rounds"}
    assert desc["materials"] == [{"albedo": tuple(CONFIG["albedo"])}]
    ((m, mat, pose, scale),) = desc["instances"]
    assert (m, mat) == (0, 0) and not pose.any() and (scale == 1).all()


def test_the_configurations_triangles_are_the_scenes():
    assert scenes.triangle_count(scenes.scene(CONFIG)) == CONFIG["triangles"] == 256002
    assert CONFIG["reduced"] == [] and CONFIG["tiny"]["args"].keys() <= CONFIG["args"].keys()


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, info):
    with profiling.setup(name) as s:
        s.info = info


def _read(metric, triangles=400):
    return spec.metric_reader(metric).read(run.Context(None, [], {}, triangles))


def test_tree_sah_weights_the_scenes_latest_bvh_spans_by_triangles(record):
    _span("bvh", {"cache_hit": True, "opt_rounds": 0, "triangles": 50, "sah": 99.0})  # an older scene
    _span("bvh", {"cache_hit": False, "opt_rounds": 2, "triangles": 100, "sah": 10.0})
    _span("bvh", {"cache_hit": True, "opt_rounds": 0, "triangles": 300, "sah": 20.0})
    _span("compile", None)
    assert _read("tree_sah") == pytest.approx((100 * 10.0 + 300 * 20.0) / 400)
    assert _read("tree_sah", triangles=350) is None  # the spans do not add up to the scene


def test_wide_tree_sah_weights_the_latest_compiles_meshes_by_triangles(record):
    _span("compile", {"wide_sah": [7.0], "wide_triangles": [10]})  # an older scene
    _span("compile", {"wide_sah": [2.0, 4.0], "wide_triangles": [100, 300]})
    assert _read("wide_tree_sah") == pytest.approx(3.5)
    _span("compile", None)  # a scene on the route: no resident 4-wide tables
    assert _read("wide_tree_sah") is None


def test_the_readers_give_none_without_the_info(record):
    assert _read("tree_sah") is None and _read("wide_tree_sah") is None
    _span("bvh", {"cache_hit": False})  # what a port without the info records
    _span("compile", None)
    assert _read("tree_sah", triangles=80) is None and _read("wide_tree_sah") is None
