"""The compiled sharded entry points (``parallel/sharding.py`` and
``parallel/scene_shard.py`` ``compiled_*``, ``render/compiled.py``) and
``render()`` / ``render_image_paged`` through ``compiled_render_image``, on
the CPU, where an entry binds its inputs and runs its body with no
capture.

One set of 2 gloo ranks (``parallel.group.spawn``, each case one call of
``run_calls``) runs every sharded case, at ``test_torch_sharding.py``'s
64x48 pair (row bands) and ``test_torch_scene_shard.py``'s 64x64 chunks
of the same pair:

  * each of the six compiled entries is bitwise its eager entry at 2
    poses (the path entries at 2 poses by 2 keys), every call after the
    first reusing the one entry, and the ranks hold the same image;
  * a second ``Group`` over the same ranks gets an entry of its own, and
    renders the same frame;
  * against the JAX package's jitted ``render_image_sharded`` (``bvh``)
    and ``render_image_scene_sharded`` (``brute``) on 2 of conftest's
    virtual devices: the row bands 0 pixels apart, the scene shards
    within ``test_torch_scene_shard.py``'s 1% of the pixels.

In this process: ``render()`` and ``render_image_paged`` make one entry
of ``compiled_render_image`` each, bitwise the eager frame (``render()``
also the JAX package's ``render``); the sharded configs are refused
before any entry is made; a compiled frame called inside another's body
raises.

The calls run in the ranks' processes, which import this module: JAX is
imported inside the tests that use it, not at the top.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer_torch.parallel import COMPILED_SHARDED, scene_shard, sharding
from tpu_raytracer_torch.parallel.group import Group, PerRank, run_calls, spawn
from tpu_raytracer_torch.render import RenderConfig, pipeline
from tpu_raytracer_torch.render.compiled import CompiledFrame
from tpu_raytracer_torch.utils import prng

torch.set_num_threads(1)

WORLD = 2
W, H = 64, 48  # the row bands' frame (test_torch_sharding.py)
S = 64  # the scene shards' frame (test_torch_scene_shard.py)
POSES = 2
KEYS = (11, 12)
# share of the pixels a scene-sharded frame may differ from JAX's:
# test_torch_scene_shard.py's bound
PIXEL_SHARE = 0.01
MODULES = {"rows": sharding, "shards": scene_shard}


@pytest.fixture(autouse=True)
def no_entries():
    pipeline.clear_compiled()
    yield
    pipeline.clear_compiled()


def _pair(S_, R, w, h, reflectivity=0.0):
    from test_torch_sharding import pair

    scene, cam = pair(S_, R)
    scene.materials[0].reflectivity = reflectivity
    return scene, R.Camera.looking(w, h, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])


def _posed(cam, n: int) -> list:
    """Camera arguments at ``n`` poses, each moved a small step."""
    start = cam.pose.copy()
    out = []
    for step in range(n):
        cam.pose = start + np.float32(0.05 * step) * np.array([1, 1, 0.5, 1, 0.2, 0],
                                                             np.float32)
        p = cam.ray_params("cpu")
        out.append((p["K_inv"], p["D"], p["pose"], p["inv_pose"]))
    cam.pose = start
    return out


def _cases() -> dict:
    """{case: (module, entry, config, scene or PerRank chunks, poses,
    extra argument tuples)}: every sharded frame entry."""
    scene, cam = _pair(ts, tr, W, H, reflectivity=0.5)
    rows = scene.compile("cpu")
    rposes = _posed(cam, POSES)
    host, scam = _pair(ts, tr, S, S, reflectivity=0.5)
    chunks = PerRank(tuple(scene_shard.shard_compile(host, WORLD, device="cpu")))
    sposes = _posed(scam, POSES)
    keys = [prng.PRNGKey(k) for k in KEYS]
    cfg = lambda w, h, backend, **kw: RenderConfig(w, h, backend=backend, **kw)
    return {
        "rows_primary": ("rows", "render_image_sharded", cfg(W, H, "bvh"), rows, rposes, [()]),
        "rows_whitted": ("rows", "render_image_whitted_sharded", cfg(W, H, "cuda"), rows,
                         rposes, [(1,)]),
        "rows_path": ("rows", "render_image_path_traced_sharded", cfg(W, H, "bvh"), rows,
                      rposes, [(k, 2, 2) for k in keys]),
        "shards_primary": ("shards", "render_image_scene_sharded",
                           cfg(S, S, "bvh", lighting="lambert_shadow"), chunks, sposes, [()]),
        "shards_whitted": ("shards", "render_image_whitted_scene_sharded", cfg(S, S, "bvh"),
                           chunks, sposes, [(1,)]),
        "shards_path": ("shards", "render_image_path_scene_sharded", cfg(S, S, "cuda"),
                        chunks, sposes, [(k, 2, 2) for k in keys]),
    }


def case_frames(mod: str, entry: str, cfg, group: Group, scene, poses, extras) -> dict:
    """One case on this rank (a ``run_calls`` call): the compiled and eager
    frames at every pose and extra argument tuple, the entries the
    compiled entry point holds after them, and whether it captured."""
    eager = getattr(MODULES[mod], entry)
    fast = getattr(MODULES[mod], "compiled_" + entry)
    got, want = [], []
    for args in poses:
        for extra in extras:
            got.append(fast(cfg, group, scene, *args, *extra))
            want.append(eager(cfg, group, scene, *args, *extra))
    return {"got": got, "want": want, "entries": len(fast.entries),
            "captured": fast.last.graph is not None}


def second_group(cfg, group: Group, scene, args) -> dict:
    """The primary row band through a second ``Group`` over the same ranks
    (a ``run_calls`` call after the cases): its frame, whether it made an
    entry of its own; then ``clear_compiled``'s count of what is left."""
    other = Group(rank=group.rank, world_size=group.world_size, device=group.device,
                  backend=group.backend, pg=dist.new_group(list(range(group.world_size))))
    fast = sharding.compiled_render_image_sharded
    first = fast.last
    img = fast(cfg, other, scene, *args)
    out = {"img": img, "entries": len(fast.entries), "new_entry": fast.last is not first}
    pipeline.clear_compiled()
    out["cleared"] = sum(len(f.entries) for f in COMPILED_SHARDED)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Every case, then the second group, in one set of ranks."""
    cases = _cases()
    calls = [(WORLD, functools.partial(case_frames, mod, entry, cfg), (scene, poses, extras))
             for mod, entry, cfg, scene, poses, extras in cases.values()]
    _, _, cfg, rows, poses, _ = cases["rows_primary"]
    calls.append((WORLD, functools.partial(second_group, cfg), (rows, poses[0])))
    out = spawn(run_calls, WORLD, args=(calls,), device="cpu")
    return cases, [dict(zip(list(cases) + ["second_group"], r)) for r in out]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


CASES = ("rows_primary", "rows_whitted", "rows_path", "shards_primary", "shards_whitted",
         "shards_path")


@pytest.mark.parametrize("case", CASES)
def test_compiled_sharded_entry_is_the_eager_entry(ranks, case):
    cases, results = ranks
    _, _, cfg, _, poses, extras = cases[case]
    for r, res in enumerate(results):
        got, want = res[case]["got"], res[case]["want"]
        assert len(got) == len(want) == len(poses) * len(extras)
        for g, w, g0 in zip(got, want, results[0][case]["got"]):
            assert g.shape == (cfg.height, cfg.width, 3) and g.dtype == torch.uint8
            assert _same(g, w), f"rank {r}: the compiled frame is not the eager one"
            assert _same(g, g0), f"rank {r} holds another image than rank 0"
        # one entry for every pose and key; no capture on the CPU
        assert res[case]["entries"] == 1 and not res[case]["captured"]
    frames = results[0][case]["got"]
    assert all((f != f[0, 0]).any() for f in frames)  # not one colour
    assert not _same(frames[0], frames[len(extras)])  # the pose moved the frame
    if len(extras) > 1:
        assert not _same(frames[0], frames[1])  # so did the key


def test_a_second_group_gets_its_own_entry(ranks):
    _, results = ranks
    for res in results:
        second = res["second_group"]
        assert second["new_entry"] and second["entries"] == 2
        assert _same(second["img"], res["rows_primary"]["got"][0])
        assert second["cleared"] == 0  # clear_compiled clears the sharded entries


def test_compiled_row_bands_and_scene_shards_match_jax(ranks):
    """The compiled primary frames at the first pose against the JAX
    package's jitted sharded entries on 2 virtual devices."""
    import tpu_raytracer.render as jr
    import tpu_raytracer.scene as js
    from tpu_raytracer.parallel import make_mesh, render_image_sharded
    from tpu_raytracer.parallel import scene_shard as jss

    cases, results = ranks
    scene, cam = _pair(js, jr, W, H, reflectivity=0.5)
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    want = np.asarray(render_image_sharded(jr.RenderConfig(W, H, backend="bvh"),
                                           make_mesh(WORLD), scene.compile(), *args))
    got = results[0]["rows_primary"]["got"][0].numpy()
    assert int((got != want).any(-1).sum()) == 0

    host, scam = _pair(js, jr, S, S, reflectivity=0.5)
    p = scam.ray_params()
    cfg = cases["shards_primary"][2]
    want = np.asarray(jss.render_image_scene_sharded(
        jr.RenderConfig(S, S, backend="brute", lighting=cfg.lighting),
        make_mesh(WORLD, axis="scene"), jss.shard_compile(host, WORLD), p["K_inv"], p["D"],
        p["pose"], p["inv_pose"]))
    got = results[0]["shards_primary"]["got"][0].numpy()
    differ = int((got != want).any(-1).sum())
    print(f"scene shards: {differ} of {S * S} pixels differ from JAX's 2-device frame")
    assert differ <= PIXEL_SHARE * S * S
    assert (want != want[0, 0]).any()


def test_sharded_configs_are_refused_before_any_entry():
    scene, cam = _pair(ts, tr, W, H)
    rows = scene.compile("cpu")
    args = _posed(cam, 1)[0]
    g = Group(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="ssaa"):
        sharding.compiled_render_image_sharded(RenderConfig(W, H, ssaa=2), g, rows, *args)
    with pytest.raises(ValueError, match="denoise"):
        sharding.compiled_render_image_path_traced_sharded(RenderConfig(W, H, denoise=1), g,
                                                           rows, *args, prng.PRNGKey(0))
    shards = scene_shard.shard_compile(scene, 2, device="cpu")
    with pytest.raises(ValueError, match="rank 0 holds chunk 1"):
        scene_shard.compiled_render_image_scene_sharded(RenderConfig(W, H, backend="bvh"), g,
                                                        shards[1], *args)
    with pytest.raises(ValueError, match="backends"):
        scene_shard.compiled_render_image_whitted_scene_sharded(
            RenderConfig(W, H, backend="paged"), g, shards[0], *args)
    assert all(not f.entries for f in COMPILED_SHARDED)


def _cam_args(cam, step=0):
    return _posed(cam, step + 1)[step]


def test_render_goes_through_compiled_render_image():
    """``render()`` adds one entry to ``compiled_render_image``, reused at a
    second pose, each frame bitwise the eager ``render_image``'s; its frame
    is the JAX package's ``render``'s."""
    import tpu_raytracer.render as jr

    from test_torch_scene import compiled

    ja, jcam = compiled("cube_tex64", "jax")
    pa, pcam = compiled("cube_tex64", "torch")
    frame = pipeline.compiled_render_image
    got = tr.render(pcam, pa, backend="bvh")
    assert len(frame.entries) == 1
    eager = tr.render_image(RenderConfig(64, 64, backend="bvh"), pa, *_cam_args(pcam))
    assert _same(got, eager)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr.render(jcam, ja, backend="bvh")))
    # a moved copy: the recipe's camera is shared with other tests
    pcam = dataclasses.replace(
        pcam, pose=pcam.pose + np.array([0.2, 0.1, 0.0, 0.1, 0.0, 0.0], np.float32))
    moved = tr.render(pcam, pa, backend="bvh")
    assert len(frame.entries) == 1
    assert _same(moved, tr.render_image(RenderConfig(64, 64, backend="bvh"), pa,
                                        *_cam_args(pcam)))
    assert not _same(moved, got)


def test_render_image_paged_goes_through_compiled_render_image():
    """``render_image_paged`` (K4's plain version on 4-wide pages) adds one
    entry to ``compiled_render_image``, reused at a second pose, each frame
    bitwise the eager ``paged`` frame."""
    scene, cam = _pair(ts, tr, W, H)
    paged = scene.compile("cpu").with_paging(page_tris=32, page_nodes=64)
    cfg = RenderConfig(W, H, lighting="lambert")
    frames = []
    for args in _posed(cam, POSES):
        got = tr.render_image_paged(cfg, paged, *args)
        want = tr.render_image(dataclasses.replace(cfg, backend="paged"), paged, *args)
        assert _same(got, want)
        frames.append(got)
    assert len(pipeline.compiled_render_image.entries) == 1
    assert pipeline.compiled_render_image.last.args[0].backend == "paged"
    assert not _same(*frames)


def test_a_compiled_frame_inside_a_compiled_body_raises():
    """A capture cannot nest: a compiled frame called from another one's
    body raises, and the outer frame keeps no entry."""
    scene, cam = _pair(ts, tr, 16, 16)
    sc = scene.compile("cpu")

    def outer(config, scene_, K_inv, D, pose, inv_pose):
        return pipeline.compiled_render_image(config, scene_, K_inv, D, pose, inv_pose)

    nested = CompiledFrame(outer)
    with pytest.raises(RuntimeError, match="inside a compiled frame's body"):
        nested(RenderConfig(16, 16), sc, *_cam_args(cam))
    assert not nested.entries and not pipeline.compiled_render_image.entries
    # the flag is down again: the frame itself runs
    img = pipeline.compiled_render_image(RenderConfig(16, 16), sc, *_cam_args(cam))
    assert img.shape == (16, 16, 3)
