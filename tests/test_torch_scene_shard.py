"""Scene shards (``tpu_raytracer_torch/parallel/scene_shard.py``) on gloo
ranks on the CPU, against the JAX package's scene-sharded compile, casts
and renders on 4 of conftest's virtual devices.

  * ``shard_compile`` against JAX's on ``test_scene_shard.py``'s posed,
    textured pair, 2 and 4 chunks: chunk sizes, stride, ``tri_mat``, BVH
    order and the 4-wide topology exactly; vertices and normals within
    1e-5 (each package bakes the instances with its own sin and cos).
  * On JAX's own chunk tables (``scene.from_stacked_shard``), the port's
    ``cast_rays_scene_sharded`` through ``bvh`` (K2's plain version) and
    ``cuda`` (K1's) against JAX's combine (``_combine_hit`` under
    ``shard_map``) of its eager brute casts of the same chunks: t, global
    tri and inst bit for bit. (JAX's ``cast_rays_scene_sharded`` compiles
    its walk, and XLA contracts FMAs in ``ray_plane_hit``: t up to 31 ulps
    apart, ``test_torch_binary.py``; the eager brute cast rounds every op
    as the port does.) ``_combine_hit`` on hand-made hits (exact-t ties
    across chunks, all-miss lanes, a tie at t = 0) against JAX's.
  * The primary (flat, ``lambert_shadow``, a point light), Whitted and
    path renders at 4 ranks against JAX's 4-device renders (its ``brute``
    casts), and against
    the port's single-device render of the same flattened scene: at most
    1% of the pixels apart (``test_torch_path.py``'s bound; JAX's own
    ``test_scene_shard.py`` allows the same against its single-device
    render); the primary frames at 1, 2 and 4 ranks bit for bit equal.
  * The refusals: a chunk count other than the world size, a backend
    without resident tables, fewer triangles than chunks, ssaa, and the
    path render with denoise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
import tpu_raytracer.scene as js
import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer.parallel import make_mesh, scene_shard as jss
from tpu_raytracer.render.integrators import PointLight as JaxPointLight
from tpu_raytracer.render.renderer import Hit as JaxHit
from tpu_raytracer.render.renderer import cast_rays_brute as jax_brute
from tpu_raytracer_torch.parallel import scene_shard as pss
from tpu_raytracer_torch.parallel.group import Group, PerRank, run_calls, spawn
from tpu_raytracer_torch.render import RenderConfig
from tpu_raytracer_torch.render.integrators import PointLight
from tpu_raytracer_torch.render.renderer import Hit
from tpu_raytracer_torch.scene.scene import from_stacked_shard
from tpu_raytracer_torch.utils import prng

from test_torch_scene import jax_fields
from test_torch_sharding import pair

torch.set_num_threads(1)

W = H = 64
# vertices and normals of the two packages' bakes (sin and cos of two libraries)
BAKE_ATOL = 1e-5
# share of the pixels a sharded frame may differ from JAX's or from the
# single-device frame: test_torch_path.py's bound (0 flips measured there)
PIXEL_SHARE = 0.01
LIGHT = ((0.0, -1.0, 2.0), 5.0)
KEY = 7


def _scene(S, R, reflectivity=0.0):
    scene, cam = pair(S, R)
    scene.materials[0].reflectivity = reflectivity
    return scene, R.Camera.looking(W, H, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])


def _cfgs(RC, P):
    """{frame: (config, reflectivity of material 0)} for the port's or
    JAX's RenderConfig ``RC`` and PointLight ``P``."""
    light = (P(*LIGHT),)
    return {
        "primary_flat": (RC(W, H, backend="bvh"), 0.0),
        "primary_shadow": (RC(W, H, backend="bvh", lighting="lambert_shadow"), 0.0),
        "primary_point": (RC(W, H, backend="bvh", lighting="lambert_shadow", point_lights=light),
                          0.0),
        "whitted": (RC(W, H, backend="bvh", point_lights=light), 0.5),
        "path": (RC(W, H, backend="bvh", path_lights=True, point_lights=light), 0.3),
        "path_sky": (RC(W, H, backend="bvh"), 0.0),
    }


def _port_entry(frame):
    if frame.startswith("primary"):
        return pss.render_image_scene_sharded, ()
    if frame == "whitted":
        return pss.render_image_whitted_scene_sharded, (1,)
    return pss.render_image_path_scene_sharded, (prng.PRNGKey(KEY), 2, 2)


@functools.lru_cache(maxsize=None)
def jax_stacked(n: int):
    return jax_fields(jss.shard_compile(_scene(js, jr)[0], n))


def jax_chunk(n: int, s: int) -> pss.SceneShard:
    """Chunk ``s`` of JAX's ``n``-chunk compile as the port's shard."""
    scene, stride = from_stacked_shard(jax_stacked(n), s, "cpu")
    return pss.SceneShard(scene, s, n, stride)


def _rays_np():
    _, cam = _scene(js, jr)
    p = cam.ray_params()
    o, d = jr.generate_rays(W, H, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    return np.asarray(o), np.asarray(d)


def hand_made_hits(n: int, stride: int):
    """Per-rank hits over 8 lanes: exact-t ties across chunks (the smaller
    global id wins), all-miss lanes, a lane only the last chunk hits, t =
    0.0 ties, and distinct nearest hits."""
    big = np.float32(3.4028235e38)
    t = np.full((n, 8), big, np.float32)
    tri = np.full((n, 8), -1, np.int32)
    for r in range(n):
        t[r, 0], tri[r, 0] = 2.5, 5 + r          # tie on every chunk
        t[r, 2], tri[r, 2] = 1.0 + r, 3          # chunk 0 nearest
        t[r, 4], tri[r, 4] = 7.0 - r, 2 * r      # the last chunk nearest
        t[r, 5], tri[r, 5] = 0.0, 9 - r          # tie at t = 0
        if r % 2:
            t[r, 6], tri[r, 6] = 4.0, 1          # ties on the odd chunks
    t[n - 1, 7], tri[n - 1, 7] = 0.75, stride - 1  # one chunk hits
    inst = np.where(tri >= 0, 0, -1).astype(np.int32)
    return t, tri, inst


@pytest.fixture(scope="module")
def port():
    """Every case on one set of 4 gloo ranks: the casts on JAX's chunk
    tables (2 and 4 chunks, bvh and cuda), the hand-made combines (2 and 4
    ranks), and the renders (the primary frames at 1, 2 and 4 chunks, the
    rest at 4)."""
    o, d = (torch.from_numpy(np.array(x)) for x in _rays_np())
    calls, keys = [], []
    for n in (2, 4):
        shards = tuple(jax_chunk(n, s) for s in range(n))
        for backend in ("bvh", "cuda"):
            calls.append((n, pss.cast_rays_scene_sharded, (PerRank(shards), o, d, backend)))
            keys.append(("cast", n, backend))
        t, tri, inst = hand_made_hits(n, 16)
        hits = tuple(Hit(*(torch.from_numpy(x[r]) for x in (t, tri, inst))) for r in range(n))
        calls.append((n, pss._combine_hit, (PerRank(hits), PerRank(tuple(range(n))), 16)))
        keys.append(("combine", n, None))
    for frame, (cfg, refl) in _cfgs(RenderConfig, PointLight).items():
        scene, cam = _scene(ts, tr, refl)
        p = cam.ray_params("cpu")
        cam_args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        entry, extra = _port_entry(frame)
        for n in ((1, 2, 4) if frame.startswith("primary") else (4,)):
            shards = tuple(pss.shard_compile(scene, n, device="cpu"))
            calls.append((n, functools.partial(entry, cfg), (PerRank(shards), *cam_args, *extra)))
            keys.append((frame, n, None))
    ranks = spawn(run_calls, 4, args=(calls,), device="cpu")
    return {k: [ranks[r][i] for r in range(k[1])] for i, k in enumerate(keys)}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_compile_matches_jax(n):
    ours = pss.shard_compile(_scene(ts, tr)[0], n, device="cpu")
    jax_f = jax_stacked(n)
    stride = jax_f["tri_v0"].shape[1]
    assert [s.stride for s in ours] == [stride] * n
    assert [(s.shard, s.n_shards) for s in ours] == [(s, n) for s in range(n)]
    assert max(s.scene.num_triangles for s in ours) == stride
    for s, shard in enumerate(ours):
        want, _ = from_stacked_shard(jax_f, s, "cpu")
        got = shard.scene
        assert got.num_instances == 1 and got.tlas is None and got.paged is None
        assert got.num_triangles == want.num_triangles
        for f in ("tri_mat", "tri_mesh", "node_child_a", "node_child_b", "node_leaf_start",
                  "node_leaf_count", "mesh_root", "tri_uv0", "tri_uv1", "tri_uv2",
                  "mat_tex_start", "tex_atlas", "sky_tex_start"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
        for f in ("tri_v0", "tri_v1", "tri_v2", "tri_normal", "node_min", "node_max"):
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                       rtol=0, atol=BAKE_ATOL, err_msg=f)
        np.testing.assert_array_equal(got.wide4.wcode.numpy(), want.wide4.wcode.numpy())
        assert got.wide4.max_leaf == max(x.scene.wide4.max_leaf for x in ours)
        # the padding JAX stacks: ints -1, floats 0
        assert (jax_f["tri_mesh"][s, got.num_triangles:] == -1).all()
        assert (jax_f["tri_v0"][s, got.num_triangles:] == 0).all()
    # ceil(T / n) real triangles (tri_mat >= 0) per chunk, the rest last
    total = _scene(ts, tr)[0].flattened()[0].meshes[0].num_triangles
    per = -(-total // n)
    assert [int((s.scene.tri_mat >= 0).sum()) for s in ours] == [per] * (n - 1) + [
        total - per * (n - 1)]


@functools.lru_cache(maxsize=None)
def jax_cast(n: int):
    """JAX's combine of its eager brute casts of its ``n`` chunks."""
    stacked = jss.shard_compile(_scene(js, jr)[0], n)
    o, d = _rays_np()
    hits = [jax_brute(jax.tree.map(lambda a: a[s], stacked), o, d) for s in range(n)]
    return _jax_combine(*(np.stack([np.asarray(getattr(h, f)) for h in hits])
                          for f in ("t", "tri", "inst")), stacked.tri_v0.shape[1])


@pytest.mark.parametrize("backend", ["bvh", "cuda"])
@pytest.mark.parametrize("n", [2, 4])
def test_cast_on_jax_chunk_tables_is_jax_bit_for_bit(port, n, backend):
    hits = port["cast", n, backend]
    t, tri, inst, _ = jax_cast(n)
    for r, h in enumerate(hits):
        for f in ("t", "tri", "inst"):
            assert torch.equal(getattr(h, f), getattr(hits[0], f)), (r, f)
    h = hits[0]
    np.testing.assert_array_equal(h.t.numpy().view(np.int32), t[0].view(np.int32))
    np.testing.assert_array_equal(h.tri.numpy(), tri[0])
    np.testing.assert_array_equal(h.inst.numpy(), inst[0])
    assert (h.tri >= 0).sum() > 200 and (h.tri < 0).sum() > 200


def _jax_combine(t, tri, inst, stride: int):
    """JAX's ``_combine_hit`` over per-chunk hits ``[n, ...]`` on an
    n-device mesh: (t, tri, inst, winner), each ``[n, ...]``, chunk i's
    view first."""
    n = t.shape[0]
    mesh = make_mesh(n, axis="scene")

    def body(t, tri, inst):
        sid = jax.lax.axis_index("scene")
        hit, winner = jss._combine_hit(JaxHit(t=t[0], tri=tri[0], inst=inst[0]), sid, stride,
                                       "scene")
        return hit.t[None], hit.tri[None], hit.inst[None], winner[None]

    P = jax.sharding.PartitionSpec
    out = jax.shard_map(body, mesh=mesh, in_specs=(P("scene"),) * 3,
                        out_specs=(P("scene"),) * 4, check_vma=False)(
        jnp.asarray(t), jnp.asarray(tri), jnp.asarray(inst))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n", [2, 4])
def test_combine_hit_matches_jax(port, n):
    jt, jtri, jinst, jwin = _jax_combine(*hand_made_hits(n, 16), 16)
    for r, (hit, winner, extra) in enumerate(port["combine", n, None]):
        assert extra is None
        np.testing.assert_array_equal(hit.t.numpy().view(np.int32), jt[r].view(np.int32))
        np.testing.assert_array_equal(hit.tri.numpy(), jtri[r])
        np.testing.assert_array_equal(hit.inst.numpy(), jinst[r])
        np.testing.assert_array_equal(winner.numpy(), jwin[r])
    hit = port["combine", n, None][0][0]
    assert hit.tri.tolist()[:2] == [5, -1]  # the tie goes to chunk 0's id; all miss
    assert hit.tri[4].item() == 2 * (n - 1) + 16 * (n - 1)  # the last chunk's global id
    assert hit.tri[7].item() == 16 * n - 1


@functools.lru_cache(maxsize=None)
def jax_frame(frame: str) -> np.ndarray:
    from tpu_raytracer.parallel import (
        render_image_path_scene_sharded, render_image_scene_sharded,
        render_image_whitted_scene_sharded,
    )

    cfg, refl = _cfgs(jr.RenderConfig, JaxPointLight)[frame]
    cfg = dataclasses.replace(cfg, backend="brute")  # compiles in a third of bvh's time
    scene, cam = _scene(js, jr, refl)
    p = cam.ray_params()
    args = (make_mesh(4, axis="scene"), jss.shard_compile(scene, 4), p["K_inv"], p["D"],
            p["pose"], p["inv_pose"])
    if frame.startswith("primary"):
        return np.asarray(render_image_scene_sharded(cfg, *args))
    if frame == "whitted":
        return np.asarray(render_image_whitted_scene_sharded(cfg, *args, max_bounces=1))
    return np.asarray(render_image_path_scene_sharded(cfg, *args, jax.random.PRNGKey(KEY),
                                                      max_bounces=2, samples=2))


def _single_device(frame: str) -> torch.Tensor:
    cfg, refl = _cfgs(RenderConfig, PointLight)[frame]
    scene, cam = _scene(ts, tr, refl)
    flat = scene.compile("cpu", flatten_static=True)
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    if frame.startswith("primary"):
        return tr.render_image(cfg, flat, *args)
    if frame == "whitted":
        return tr.render_image_whitted(cfg, flat, *args, max_bounces=1)
    return tr.render_image_path_traced(cfg, flat, *args, prng.PRNGKey(KEY), max_bounces=2,
                                       samples=2)


@pytest.mark.parametrize("frame", list(_cfgs(RenderConfig, PointLight)))
def test_scene_sharded_frames(port, frame):
    imgs = port[frame, 4, None]
    for r, img in enumerate(imgs):
        assert img.shape == (H, W, 3) and img.dtype == torch.uint8
        assert torch.equal(img, imgs[0]), f"rank {r} holds another image"
    got = imgs[0].numpy()
    if frame.startswith("primary"):
        for n in (1, 2):
            assert torch.equal(port[frame, n, None][0], imgs[0]), n
    vs_jax = int((got != jax_frame(frame)).any(-1).sum())
    vs_single = int((got != _single_device(frame).numpy()).any(-1).sum())
    print(f"{frame}: {vs_jax} pixels from JAX's 4-device frame, {vs_single} from the "
          f"single-device frame of the flattened scene, of {H * W}")
    assert vs_jax <= PIXEL_SHARE * H * W
    assert vs_single <= PIXEL_SHARE * H * W
    assert (got != got[0, 0]).any()


def test_refusals():
    scene, cam = _scene(ts, tr)
    shards = pss.shard_compile(scene, 2, device="cpu")
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    cfg = RenderConfig(W, H, backend="bvh")
    g4 = Group(rank=0, world_size=4, device=torch.device("cpu"), backend="gloo")
    g2 = Group(rank=1, world_size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="2 chunks for 4 ranks"):
        pss.render_image_scene_sharded(cfg, g4, shards[0], *args)
    with pytest.raises(ValueError, match="rank 1 holds chunk 0"):
        pss.cast_rays_scene_sharded(g2, shards[0], torch.zeros(3), torch.ones(4, 3))
    with pytest.raises(ValueError, match="backends"):
        pss.render_image_scene_sharded(RenderConfig(W, H, backend="paged"), g2, shards[1], *args)
    with pytest.raises(ValueError, match="ssaa"):
        pss.render_image_whitted_scene_sharded(RenderConfig(W, H, ssaa=2), g2, shards[1], *args)
    with pytest.raises(ValueError, match="denoise"):
        pss.render_image_path_scene_sharded(RenderConfig(W, H, denoise=1), g2, shards[1], *args,
                                            prng.PRNGKey(0))
    tiny = ts.Scene()
    tiny.add_material(ts.Material())
    v = np.eye(3, dtype=np.float32)
    tiny.add_mesh(ts.MeshPrimitive.from_triangles(v[None, 0], v[None, 1], v[None, 2]))
    tiny.add_mesh_instance(ts.MeshInstance(0, 0))
    with pytest.raises(ValueError, match="fewer triangles"):
        pss.shard_compile(tiny, 2, device="cpu")
