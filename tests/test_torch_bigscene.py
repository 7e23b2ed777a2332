"""The big-scene route of the port on the CPU: the leaf code's row limit
in ``collapse4``/``collapse2``, ``Scene.compile(auto_page)`` and
``SceneTensors.needs_paging``, and the ``cuda`` and ``bvh`` backends'
paged branch, against the JAX package.

A scene past the limit has over 2M triangle rows, too big for a CPU test,
so the rule's rows (``kernels/traversal.py PAGING_ROWS``) are lowered
below the test scenes' rows, as ``tests/test_paged.py`` lowers the JAX
package's VMEM budget; the leaf code's own limit (``accel/wide.py
LEAF_ROWS``) is held on synthetic trees, and the page trees build as
they would on a big scene. Scenes: the JAX package's two-instance test scene (carried
over with ``from_scene_arrays``) and the small colonnade (``columns=4,
segs=8``: 13,320 rows), at 32x32 with the JAX package's primary rays.

Tolerances. The routed casts are the forced ``paged`` cast itself, so
they and the frames they make are equal bit for bit. Against the JAX
package's eager brute cast ``t`` is within 1e-5 but where a hit lies up
to EDGE_EPS outside its leaf box (``traversal.unexplained_differences``
must find 0). Against the JAX ``bvh`` images: the primary and Whitted
frames within 2 pixels (the bound of ``test_torch_whitted.py``'s demo:
rays that graze an edge outside a box the port tests and the XLA walk
does not), the path frame within 1% of its pixels
(``test_torch_path.py``'s bound).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
from tpu_raytracer.accel.wide import collapse4 as jax_collapse4
from tpu_raytracer.render import Camera as JaxCamera
from tpu_raytracer.render import RenderConfig as JaxConfig
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render import render_image as jax_render_image
from tpu_raytracer.render import render_image_path_traced as jax_render_path
from tpu_raytracer.render import render_image_whitted as jax_render_whitted
from tpu_raytracer.render.renderer import cast_rays_brute as jax_brute
from tpu_raytracer_torch.accel import wide
from tpu_raytracer_torch.kernels import paged, traversal
from tpu_raytracer_torch.render import Hit, RenderConfig, render_image, render_image_whitted
from tpu_raytracer_torch.render.pipeline import render_image_path_traced
from tpu_raytracer_torch.render.renderer import get_cast_fn, occlusion_cast_fn
from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen
from tpu_raytracer_torch.scene.scene import SceneTensors, from_scene_arrays
from tpu_raytracer_torch.utils import profiling, prng

from test_pallas_interpret import _two_instance_scene
from test_torch_scene import jax_fields

torch.set_num_threads(1)

SIZE = 32
LIMIT = 64  # the lowered PAGING_ROWS: below both scenes' rows
BRUTE_TOL = 1e-5
JAX_PIXELS = 2  # primary and Whitted frames against the JAX bvh images
PATH_SHARE = 0.01  # path frame: pixels apart from the JAX bvh frame


def colonnade_scene() -> Scene:
    """The port's ``scene_colonnade(columns=4, segs=8)``, uncompiled."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.colonnade(4, 4, 8)))
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene


JAX_SCENES = {
    "two_instance": _two_instance_scene,
    "colonnade": lambda: jscenes.scene_colonnade(SIZE, SIZE, columns=4, segs=8),
}


@functools.lru_cache(maxsize=None)
def jax_scene(name):
    """(JAX arrays, JAX ray params, origin, directions) at SIZE x SIZE."""
    arrays, cam = JAX_SCENES[name]()
    cam = JaxCamera.looking(SIZE, SIZE, fov_deg=55.0 if name == "two_instance" else 65.0,
                            pose=cam.pose)
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = jax_generate_rays(SIZE, SIZE, *args)
    return arrays, args, np.array(o), np.array(d)


@pytest.fixture
def low_limit(monkeypatch):
    monkeypatch.setattr(traversal, "PAGING_ROWS", LIMIT)


def paged_scene(name) -> tuple:
    """(port scene compiled past the lowered limit, ray params, origin,
    directions); call under ``low_limit``."""
    arrays, args, o, d = jax_scene(name)
    scene = from_scene_arrays(jax_fields(arrays), device="cpu")
    return (scene, tuple(torch.from_numpy(np.array(a)) for a in args), torch.from_numpy(o),
            torch.from_numpy(d))


def tree(start: int):
    """A binary tree of one root and two leaves (8 triangles at row 0, 3
    at ``start``), as ``collapse4``/``collapse2`` take it."""
    child_a = np.array([1, -1, -1], np.int32)
    child_b = np.array([2, -1, -1], np.int32)
    leaf_start = np.array([0, 0, start], np.int64)
    leaf_count = np.array([0, 8, 3], np.int32)
    node_min = np.zeros((3, 3), np.float32)
    node_max = np.ones((3, 3), np.float32)
    return child_a, child_b, leaf_start, leaf_count, node_min, node_max, np.zeros(1, np.int32)


@pytest.mark.parametrize("collapse", ["collapse4", "collapse2"])
def test_leaf_codes_stop_at_the_limit(collapse):
    """A leaf at row 2^21 - 1 gets JAX's code; one at 2^21 raises, where
    ``collapse4`` raised OverflowError and ``collapse2`` wrapped to a
    positive code, which reads as an internal node."""
    fn = getattr(wide, collapse)
    last = wide.LEAF_ROWS - 1
    assert wide.LEAF_ROWS == 1 << 21
    got = fn(*tree(last))
    want_code = -(last * 1024 + 3) - 1
    assert want_code >= -(2 ** 31)
    if collapse == "collapse4":
        want = jax_collapse4(*tree(last))
        np.testing.assert_array_equal(got.wcode, want.wcode)
        np.testing.assert_array_equal(got.wbox_min, want.wbox_min)
        np.testing.assert_array_equal(got.wroot, want.wroot)
    assert want_code in got.wcode.tolist() and (got.wcode < 0).sum() >= 2
    with pytest.raises(ValueError, match=r"LEAF_ROWS.*with_paging"):
        fn(*tree(wide.LEAF_ROWS))
    # page-local starts: a page holds at most the rows a leaf code addresses
    assert paged.MAX_PAGE_TRIS == wide.LEAF_ROWS


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_compile_attaches_page_tables_past_the_limit(monkeypatch, name):
    fields = jax_fields(jax_scene(name)[0])
    resident = from_scene_arrays(fields, device="cpu")
    monkeypatch.setattr(traversal, "PAGING_ROWS", LIMIT)
    with pytest.raises(ValueError, match=r"PAGING_ROWS.*with_paging"):
        from_scene_arrays(fields, device="cpu", auto_page=False)
    scene = paged_scene(name)[0]
    assert scene.needs_paging() and scene.paged is not None and scene.paged.arity == 4
    assert (scene.paged.page_tris, scene.paged.page_nodes) == (8192, 4096)
    assert scene.wide4 is None and scene.binary is None and scene.tlas is None
    np.testing.assert_array_equal(scene.tri_rec.numpy(), resident.tri_rec.numpy())
    assert resident.wide4.tri_rec is resident.tri_rec
    assert scene.with_paging() is scene  # app/driver.py's --backend paged keeps them
    binary = scene.with_paging(wide=False)
    assert binary.paged.arity == 2 and binary.with_paging(wide=False) is binary
    moved = scene.to("cpu")
    assert moved.paged.num_pages == scene.paged.num_pages and moved.tri_rec is not None
    starts = resident.node_leaf_start.numpy()
    wide.check_leaf_rows(resident.node_child_a.numpy(), starts + wide.LEAF_ROWS - 1 - starts.max())
    with pytest.raises(ValueError, match="LEAF_ROWS"):
        wide.check_leaf_rows(resident.node_child_a.numpy(), starts + wide.LEAF_ROWS)


def test_scene_compile_auto_page(low_limit, tmp_path):
    """``Scene.compile`` pages past the limit and raises there with
    ``auto_page=False``; a saved scene loads paged."""
    scene = colonnade_scene().compile("cpu")
    assert scene.needs_paging() and scene.paged is not None and scene.wide4 is None
    flat = colonnade_scene().compile("cpu", flatten_static=True)
    assert flat.paged is not None and flat.wide4 is None
    with pytest.raises(ValueError, match=r"PAGING_ROWS.*with_paging"):
        colonnade_scene().compile("cpu", auto_page=False)
    scene.save(str(tmp_path / "big.npz"))
    loaded = SceneTensors.load(str(tmp_path / "big.npz"), device="cpu")
    assert loaded.paged is not None and loaded.wide4 is None
    for k in ("top_code", "code", "box", "page_tri0"):
        assert torch.equal(getattr(loaded.paged, k), getattr(scene.paged, k))


def paging_spans() -> list:
    return [s for s in profiling.spans() if s.name == "setup.paging"]


def test_the_page_build_is_a_setup_span_inside_the_compile(low_limit):
    """The host build of the page tables (``SceneTensors.with_paging``) is
    the set-up span ``setup.paging``, inside ``setup.compile`` when the
    compile pages a scene; its info the pages, the scene's triangle rows
    and the tables' bytes. Tables already attached build nothing."""
    profiling.clear()
    scene = colonnade_scene().compile("cpu")
    (span,) = paging_spans()
    (compile_span,) = [s for s in profiling.spans() if s.name == "setup.compile"]
    assert span.parent == "setup.compile" and span.t1_ns > span.t0_ns
    assert compile_span.t0_ns <= span.t0_ns and span.t1_ns <= compile_span.t1_ns
    pg = scene.paged
    nbytes = sum(t.nbytes for t in vars(pg).values() if isinstance(t, torch.Tensor))
    assert span.info == {"pages": pg.num_pages, "rows": scene.num_triangles, "bytes": nbytes}
    assert span.info["rows"] >= LIMIT and span.info["bytes"] > 0
    assert scene.with_paging() is scene and len(paging_spans()) == 1
    binary = scene.with_paging(wide=False)  # called alone, a span of its own
    assert [(s.parent, s.info["pages"]) for s in paging_spans()][1:] == [
        (None, binary.paged.num_pages)]


def test_a_resident_scene_opens_no_paging_span():
    profiling.clear()
    scene = colonnade_scene().compile("cpu")
    assert not scene.needs_paging() and scene.paged is None and scene.wide4 is not None
    assert paging_spans() == []
    assert [s.name for s in profiling.spans()].count("setup.compile") == 1


def test_resident_scenes_keep_their_tables():
    for name in sorted(JAX_SCENES):
        scene = from_scene_arrays(jax_fields(jax_scene(name)[0]), device="cpu")
        assert not scene.needs_paging() and scene.paged is None
        assert scene.wide4 is not None and scene.binary is not None
        assert (scene.tlas is not None) == (scene.num_instances >= 2)
    rows = colonnade_scene().compile("cpu").num_triangles
    assert rows == 13320 and rows < traversal.PAGING_ROWS == wide.LEAF_ROWS


MODES = ("nearest", "any_hit", "normals")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ["cuda", "bvh"])
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_routed_casts_equal_the_forced_paged_cast(low_limit, name, backend, mode):
    scene, _, o, d = paged_scene(name)
    want = paged.cast_rays_paged_cuda(scene, o, d)
    if mode == "any_hit":
        got = occlusion_cast_fn(backend)(scene, o, d)
        want = traversal.as_occlusion(want)
    else:
        got = get_cast_fn(backend, want_normals=mode == "normals")(scene, o, d)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got.u is None and got.v is None and got.n is None  # no carry: the redo
    assert 0.05 < float((want.t < 3e38).float().mean()) < 0.95
    # carry forced on gives no carry either
    assert traversal.cast_rays(scene, o, d, want_normals=True, carry=True).n is None


def test_a_scene_that_needs_paging_without_tables_raises(low_limit):
    scene, _, o, d = paged_scene("colonnade")
    bare = dataclasses.replace(scene, paged=None)
    for backend in ("cuda", "bvh"):
        with pytest.raises(ValueError, match="with_paging"):
            get_cast_fn(backend)(bare, o, d)
    with pytest.raises(NotImplementedError, match="K4"):
        traversal.cast_rays_cuda(scene, o, d)


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_routed_t_matches_the_jax_brute_cast(low_limit, name):
    scene, _, o, d = paged_scene(name)
    arrays, _, jo, jd = jax_scene(name)
    b = Hit(*(torch.from_numpy(np.array(x)) for x in jax_brute(arrays, jo, jd)[:3]))
    got = traversal.cast_rays(scene, o, d)
    far = ~torch.isclose(got.t, b.t, rtol=BRUTE_TOL, atol=BRUTE_TOL)
    sub = lambda h: Hit(*(x[far] for x in h[:3]))
    assert traversal.unexplained_differences(scene, o.expand(d.shape)[far], d[far],
                                             sub(got), sub(b)) == 0
    assert int(far.sum()) <= 2  # 0 measured on both scenes


@functools.lru_cache(maxsize=None)
def jax_frames(name) -> dict:
    arrays, args, _, _ = jax_scene(name)
    cfg = JaxConfig(SIZE, SIZE, backend="bvh")
    return {"flat": np.asarray(jax_render_image(cfg, arrays, *args)),
            "whitted": np.asarray(jax_render_whitted(cfg, arrays, *args)),
            "path": np.asarray(jax_render_path(cfg, arrays, *args, jax.random.PRNGKey(1), 1, 1))}


def port_frames(scene, args, backend) -> dict:
    cfg = RenderConfig(SIZE, SIZE, backend=backend)
    return {"flat": render_image(cfg, scene, *args),
            "shadow": render_image(RenderConfig(SIZE, SIZE, backend=backend,
                                                lighting="lambert_shadow"), scene, *args),
            "whitted": render_image_whitted(cfg, scene, *args),
            "path": render_image_path_traced(cfg, scene, *args, prng.PRNGKey(1), 1, 1)}


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_routed_frames_equal_forced_paged_and_jax_bvh(low_limit, name):
    scene, args, _, _ = paged_scene(name)
    forced = port_frames(scene, args, "paged")
    jax_imgs = jax_frames(name)
    for backend in ("cuda", "bvh"):
        got = port_frames(scene, args, backend)
        for mode, img in got.items():
            np.testing.assert_array_equal(img.numpy(), forced[mode].numpy(), err_msg=mode)
    for mode, want in jax_imgs.items():
        apart = int((forced[mode].numpy() != want).any(-1).sum())
        bound = PATH_SHARE * SIZE * SIZE if mode == "path" else JAX_PIXELS
        assert apart <= bound, (mode, apart)  # 0 measured; the colonnade's path frame 3
    assert (forced["shadow"].numpy() != forced["flat"].numpy()).any()


def test_scene_shard_chunks_stay_resident(monkeypatch):
    from tpu_raytracer_torch.parallel.scene_shard import shard_compile

    rows = max(s.scene.num_triangles for s in shard_compile(colonnade_scene(), 2, "cpu"))
    monkeypatch.setattr(traversal, "PAGING_ROWS", rows + 1)
    assert colonnade_scene().compile("cpu").needs_paging()
    for s in shard_compile(colonnade_scene(), 2, "cpu"):
        assert not s.scene.needs_paging() and s.scene.wide4 is not None
        assert s.scene.paged is None
    monkeypatch.setattr(traversal, "PAGING_ROWS", LIMIT)
    with pytest.raises(ValueError, match="PAGING_ROWS"):
        shard_compile(colonnade_scene(), 2, "cpu")


def test_bench_paged_says_why_k1_cannot_run(low_limit, capsys):
    from tpu_raytracer_torch import bench_paged
    from tpu_raytracer_torch.bench_all import Bench

    scene = paged_scene("colonnade")[0]
    bench_paged.route_line(Bench("cpu", "cuda", 1), scene)
    out = capsys.readouterr().out
    assert '"route": "K4"' in out and "cannot address" in out


@pytest.mark.parametrize("page", [False, True], ids=["resident", "paged"])
def test_bench_paged_sweep_lines(monkeypatch, capsys, page):
    """``bench_paged sweep`` as the command runs it, on a 2-column
    colonnade (12,802 triangles) at 16x16 with 2 runs: a scene line, a
    cast line per ray set and kernel (K1 where it can address the scene,
    else why not) and a verdict."""
    import json

    from tpu_raytracer_torch import bench_paged

    monkeypatch.setattr(bench_paged, "SWEEP_COLUMNS", (2,))
    monkeypatch.setattr(bench_paged, "SWEEP_SIZE", (16, 16))
    monkeypatch.setattr(bench_paged, "SWEEP_RUNS", 2)
    if page:
        monkeypatch.setattr(traversal, "PAGING_ROWS", LIMIT)
    bench_paged.main(["sweep", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    scene = [x for x in lines if "sweep_scene" in x]
    assert len(scene) == 1 and scene[0]["needs_paging"] == page
    assert scene[0]["attached"] == (["paged"] if page else ["wide4", "binary"])
    assert scene[0]["real_triangles"] == 12802 and scene[0]["rows"] >= 12802
    assert set(scene[0]["tables_mb"]) == ({"K4", "K5", "K6"} | (set() if page else {"K1"}))
    casts = [x for x in lines if "sweep_cast" in x and x["runs"]]
    assert sorted((x["rays"], x["kernel"]) for x in casts) == sorted(
        (r, k) for r in ("primary", "bounce") for k in ("K4", "K5", "K6") + (() if page else ("K1",)))
    for x in casts:
        assert x["n"] == 256 and x["cast_ms"]["p10"] <= x["cast_ms"]["median"] <= x["cast_ms"]["p90"]
    why = [x for x in lines if "sweep_cast" in x and not x["runs"]]
    assert len(why) == page and all("cannot address" in x["why"] for x in why)
    verdict = [x for x in lines if "sweep_verdict" in x]
    assert len(verdict) == 1 and ("beats_k1" in verdict[0]) != page
