"""Row bands (``tpu_raytracer_torch/parallel/sharding.py``) on gloo ranks
on the CPU, against the port's single-process renders and the JAX
package's ``render_image*_sharded`` on 4 of conftest's virtual devices.

One set of 4 ranks (``parallel.group.spawn``) renders every case at
world sizes 1, 2 and 4 (``run_calls``: the first n ranks form the group
of size n). The scene is ``test_scene_shard.py``'s posed, textured pair
at 64x48, so that at 2 and 4 ranks the bands (24 and 12 rows) are not
multiples of K6's 16-pixel tiles and ``paged_major`` casts in flat order.

  * Every rank returns the same full image, and it is the port's
    single-process render bit for bit (the path frame: the same bands
    rendered in one process, band i with ``fold_in(key, i)``).
  * Against JAX at 4 devices (its ``bvh`` backend): the primary, Whitted,
    ``paged`` and ``paged_major`` frames 0 pixels apart; the path frame
    within ``test_torch_path.py``'s bound (at most 1% of the pixels
    flip; 0 measured).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
import tpu_raytracer.scene as js
import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer.parallel import (
    make_mesh, render_image_path_traced_sharded as jax_path, render_image_sharded as jax_primary,
    render_image_whitted_sharded as jax_whitted,
)
from tpu_raytracer_torch.parallel import sharding
from tpu_raytracer_torch.parallel.group import Group, run_calls, spawn
from tpu_raytracer_torch.render import RenderConfig, generate_rays
from tpu_raytracer_torch.render.integrators import render_path_traced, to_u8
from tpu_raytracer_torch.utils import prng

torch.set_num_threads(1)

W, H = 64, 48
WORLD_SIZES = (1, 2, 4)
SEED = 11
# the paged cases' page capacities: several pages on this small scene
PAGE_TRIS, PAGE_NODES = 32, 64


def pair(S, R):
    """``tests/test_scene_shard.py``'s scene: an icosphere and a textured
    cube, two posed instances."""
    scene = S.Scene()
    scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2)))
    mat = S.Material()
    mat.set_texture(S.procgen.checkerboard_texture(32, 4))
    scene.add_material(mat)
    scene.add_mesh(S.MeshPrimitive.from_triangles(*S.procgen.icosphere(2)))
    scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
    a = S.MeshInstance(0, 0)
    a.pose = np.array([-0.9, 0.0, 0.0, 0.4, 0.1, 0.0], np.float32)
    b = S.MeshInstance(1, 1)
    b.pose = np.array([1.1, 0.5, 0.2, 0.0, 0.3, 0.2], np.float32)
    scene.add_mesh_instance(a)
    scene.add_mesh_instance(b)
    return scene, R.Camera.looking(W, H, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])


def _args(cam):
    p = cam.ray_params("cpu")
    return (p["K_inv"], p["D"], p["pose"], p["inv_pose"])


def _cases():
    """{case: (entry, config, scene kind, extra args)}."""
    cfg = lambda backend, **kw: RenderConfig(W, H, backend=backend, **kw)
    key = prng.PRNGKey(SEED)
    return {
        "primary_bvh": (sharding.render_image_sharded, cfg("bvh"), "plain", ()),
        "primary_cuda_shadow": (sharding.render_image_sharded,
                                cfg("cuda", lighting="lambert_shadow"), "plain", ()),
        "whitted_cuda": (sharding.render_image_whitted_sharded, cfg("cuda"), "plain", ()),
        "path_bvh": (sharding.render_image_path_traced_sharded, cfg("bvh"), "plain",
                     (key, 2, 2)),
        "paged": (sharding.render_image_sharded, cfg("paged"), "paged", ()),
        "paged_major": (sharding.render_image_sharded, cfg("paged_major"), "paged", ()),
    }


@pytest.fixture(scope="module")
def port():
    scene, cam = pair(ts, tr)
    scenes = {"plain": scene.compile("cpu")}
    scenes["paged"] = scenes["plain"].with_paging(page_tris=PAGE_TRIS, page_nodes=PAGE_NODES)
    calls = [(n, functools.partial(entry, cfg), (scenes[kind], *_args(cam), *extra))
             for n in WORLD_SIZES for entry, cfg, kind, extra in _cases().values()]
    ranks = spawn(run_calls, max(WORLD_SIZES), args=(calls,), device="cpu")
    out = {}
    for i, (n, _, _) in enumerate(calls):
        case = list(_cases())[i % len(_cases())]
        out[case, n] = [ranks[r][i] for r in range(n)]
        assert all(ranks[r][i] is None for r in range(n, len(ranks)))
    return out, scenes, cam


def _single(case, scenes, cam):
    """The port's single-process frame of ``case``; the path frame band by
    band with the folded keys."""
    entry, cfg, kind, extra = _cases()[case]
    scene, args = scenes[kind], _args(cam)
    if entry is sharding.render_image_sharded:
        return tr.render_image(cfg, scene, *args)
    if entry is sharding.render_image_whitted_sharded:
        return tr.render_image_whitted(cfg, scene, *args)
    return None


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", list(_cases()))
def test_row_bands_equal_the_single_process_render(port, case, n):
    out, scenes, cam = port
    imgs = out[case, n]
    for r, img in enumerate(imgs):
        assert img.shape == (H, W, 3) and img.dtype == torch.uint8
        assert torch.equal(img, imgs[0]), f"rank {r} holds another image"
    want = _single(case, scenes, cam)
    if want is None:  # the path frame: bands with the folded keys
        _, cfg, kind, (key, bounces, samples) = _cases()[case]
        o, d = generate_rays(W, H, *_args(cam))
        h = H // n
        want = torch.cat([to_u8(render_path_traced(
            scenes[kind], o, d[i * h:(i + 1) * h].contiguous(), prng.fold_in(key, i),
            max_bounces=bounces, samples=samples, backend=cfg.backend, sort_secondary=False))
            for i in range(n)])
    assert int((imgs[0] != want).any(-1).sum()) == 0
    assert (imgs[0] != imgs[0][0, 0]).any()  # not one colour


@functools.lru_cache(maxsize=None)
def _jax_frame(case: str) -> np.ndarray:
    scene, cam = pair(js, jr)
    arrays = scene.compile()
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _, cfg, _, _ = _cases()[case]
    jcfg = jr.RenderConfig(W, H, backend="bvh", lighting=cfg.lighting)
    mesh = make_mesh(4)
    if case.startswith("whitted"):
        return np.asarray(jax_whitted(jcfg, mesh, arrays, *args))
    if case.startswith("path"):
        return np.asarray(jax_path(jcfg, mesh, arrays, *args, jax.random.PRNGKey(SEED), 2, 2))
    return np.asarray(jax_primary(jcfg, mesh, arrays, *args))


@pytest.mark.parametrize("case", ["primary_bvh", "whitted_cuda", "path_bvh", "paged",
                                  "paged_major"])
def test_row_bands_match_jax(port, case):
    out, _, _ = port
    got = out[case, 4][0].numpy()
    want = _jax_frame("primary_bvh" if case.startswith("paged") else case)
    differ = int((got != want).any(-1).sum())
    print(f"{case}: {differ} of {H * W} pixels differ from JAX's 4-device frame")
    if case.startswith("path"):
        assert differ <= 0.01 * H * W
    else:
        assert differ == 0


def test_refusals():
    scene, cam = pair(ts, tr)
    compiled = scene.compile("cpu")
    args = _args(cam)
    g3 = Group(rank=0, world_size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="not divisible by 3"):
        sharding.render_image_sharded(RenderConfig(W, H + 1), g3, compiled, *args)
    with pytest.raises(ValueError, match="ssaa"):
        sharding.render_image_whitted_sharded(RenderConfig(W, H, ssaa=2), g3, compiled, *args)
    with pytest.raises(ValueError, match="denoise"):
        sharding.render_image_path_traced_sharded(RenderConfig(W, H, denoise=2), g3, compiled,
                                                  *args, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="nccl refuses two ranks"):
        spawn(run_calls, 2, args=([],), device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="nccl needs"):
        spawn(run_calls, 1, args=([],), device="cpu", backend="nccl")


def test_dryrun_runs_every_sharded_entry():
    """``python -m tpu_raytracer_torch.parallel.dryrun``'s body on two CPU
    ranks: every row-band and scene-sharded entry, images checked."""
    from tpu_raytracer_torch.parallel.dryrun import dryrun

    line = dryrun(2, device="cpu")
    assert line.startswith("dryrun OK on 2 ranks") and "gloo all_gather" in line


def test_band_frames_follow_the_unsharded_frame_under_shading_settings():
    """Row bands honour the settings that the JAX package's band bodies
    drop (``tpu_raytracer/parallel/sharding.py:53 _shard_body`` and :114
    ``_whitted_body`` pass no ``normal_mode``; :166 ``_path_body`` no
    ``normal_mode``, ``path_lights``, ``point_lights``,
    ``light_direction`` or ``sun_intensity``): on 2 gloo ranks at 64x64
    each band frame is the port's unsharded frame bit for bit. Config 4
    with its mirror sphere scaled non-uniformly (its cube's scale is too,
    but an axis-aligned face normal keeps its direction under either
    rule) under ``inverse_transpose``, Whitted and primary ``lambert``; config 5's path frame with
    ``path_lights`` and a point light, against its bands rendered in one
    process with the folded keys. Each setting changes the frame."""
    from tpu_raytracer_torch.app.scenes import scene_colonnade, scene_instances
    from tpu_raytracer_torch.render.integrators import PointLight, tonemap
    from tpu_raytracer_torch.render.pipeline import path_options
    from tpu_raytracer_torch.scene import MeshInstance

    n, S = 2, 64
    inst, cam4 = scene_instances(S, S, device="cpu")
    mirror = MeshInstance(0, 2)  # the sphere mesh, the mirror material
    mirror.pose = np.array([-1.2, 2.5, 0.0, 0, 0, 0], np.float32)
    mirror.scale = np.array([0.8, 0.8, 1.3], np.float32)
    inst = inst.update_instance(1, mirror)
    col, cam5 = scene_colonnade(S, S, columns=4, segs=8, device="cpu")
    it = dict(normal_mode="inverse_transpose")
    cfgs = {
        "whitted": RenderConfig(S, S, **it),
        "lambert": RenderConfig(S, S, lighting="lambert", **it),
        "path": RenderConfig(S, S, path_lights=True,
                             point_lights=(PointLight((1.0, 1.0, 2.5), 8.0),)),
    }
    key = prng.PRNGKey(SEED)
    calls = [
        (n, functools.partial(sharding.render_image_whitted_sharded, cfgs["whitted"]),
         (inst, *_args(cam4))),
        (n, functools.partial(sharding.render_image_sharded, cfgs["lambert"]),
         (inst, *_args(cam4))),
        (n, functools.partial(sharding.render_image_path_traced_sharded, cfgs["path"]),
         (col, *_args(cam5), key, 2, 2)),
    ]
    ranks = spawn(run_calls, n, args=(calls,), device="cpu")
    got = dict(zip(cfgs, ranks[0]))
    assert all(torch.equal(a, b) for a, b in zip(ranks[0], ranks[1]))

    whitted = tr.render_image_whitted(cfgs["whitted"], inst, *_args(cam4))
    lambert = tr.render_image(cfgs["lambert"], inst, *_args(cam4))
    o, d = generate_rays(S, S, *_args(cam5))
    h = S // n

    def path_bands(cfg):
        return torch.cat([to_u8(tonemap(render_path_traced(
            col, o, d[i * h:(i + 1) * h].contiguous(), prng.fold_in(key, i), max_bounces=2,
            samples=2, sort_secondary=False, **path_options(cfg)), cfg.tonemap, cfg.exposure))
            for i in range(n)])

    for name, want in (("whitted", whitted), ("lambert", lambert),
                       ("path", path_bands(cfgs["path"]))):
        assert int((got[name] != want).any(-1).sum()) == 0, name
    # the settings matter: the JAX package's band frames, which drop them,
    # would be these
    plain = dict(width=S, height=S)
    assert (tr.render_image_whitted(RenderConfig(**plain), inst, *_args(cam4)) != whitted).any()
    assert (tr.render_image(RenderConfig(**plain, lighting="lambert"), inst, *_args(cam4))
            != lambert).any()
    assert (path_bands(RenderConfig(**plain)) != got["path"]).any()
