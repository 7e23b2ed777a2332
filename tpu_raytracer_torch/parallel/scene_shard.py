"""Multi-device rendering with the geometry split over the ranks and the
rays replicated.

Counterpart of ``tpu_raytracer/parallel/scene_shard.py``. Row bands
(``sharding.py``) replicate the scene; here each rank holds a chunk of
it, the way to render a scene that outgrows one card:

  * ``shard_compile`` flattens the scene to world space
    (``Scene.flattened``) and splits the merged triangle soup, which is
    in BVH order and so spatially coherent, into ``n`` contiguous chunks
    of ``ceil(T / n)`` triangles. Each chunk is compiled as a scene of
    its own, resident (``auto_page=False``, as the JAX package compiles
    its chunks): one instance, its own BVH and 4-wide tables, the
    per-triangle materials and the scene's sky map. A chunk that needs
    paging (rows from ``kernels/traversal.py PAGING_ROWS`` on) raises:
    such a scene takes more shards. A rank keeps its own
    chunk (``SceneShard``); the chunk's triangle rows are global ids from
    ``shard * stride`` on, ``stride`` being the largest chunk's row
    count, as in the JAX package's stacked tables.
  * Every rank casts all rays against its chunk, with K1 (``cuda``) or
    K2 (``bvh``), then the ranks agree on the nearest hit: the
    lexicographic minimum of (t, global triangle), one ``all_reduce(MIN)``
    on a 64-bit key ``t bits << 32 | global tri`` (t >= 0, so the bits
    order as the values do). Shading inputs are summed over the ranks
    with every rank but the winner contributing zeros: one float sum
    (location, normal, uv) and one int sum (instance, material), which
    keep the JAX package's ``psum`` of winner-masked values, -0.0 turning
    to +0.0 included. Shadow rays take the minimum over ranks of the
    any-hit t, point lights that of the nearest t.
  * The Whitted and path renders are the single-device integrators run
    through their ``_sharded_hooks`` seam, with the keys replicated, so
    every rank computes the same radiance and the image needs no gather.

The three frame entries have ``compiled_`` counterparts with their
signatures, as the JAX package jits its ``shard_map`` entries: the whole
frame, the combine's ``all_reduce``s included, is one CUDA graph per
rank, static config and group (``render/compiled.py``,
``collectives=True``), replayed with the camera, the key and the chunk's
per-instance rows bound. Only NCCL collectives can be captured: for a
gloo group on CUDA they raise a ``ValueError`` before any entry is made
(on the CPU they run their body with no capture). Every rank must call
them alike; a rank that replays alone hangs until the group's timeout.
``cast_rays_scene_sharded`` stays eager, as the JAX package's does.

An exact-t tie across chunks goes to the smaller global id. Each chunk's
tree culls boxes in its own order, so against the single-device render
of the flattened scene a ray's t differs only where a hit lies up to
EDGE_EPS outside its leaf box (``kernels/traversal.unexplained_differences``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.vecmath import FLT_MAX
from ..render.camera import generate_rays
from ..render.integrators import render_path_traced, to_u8, tonemap
from ..render.pipeline import RenderConfig, path_options, whitted_rays
from ..render.renderer import Hit, HitAttributes, get_cast_fn, hit_attributes, occlusion_cast_fn
from ..render.shade import shade_primary
from .group import Group
from .sharding import CompiledSharded, check_sharded_config

# The candidate id of a ray a rank's chunk misses: above every global id.
_MISS_TRI = 2 ** 30
# The backends a chunk is cast with: the resident casts (the chunks carry
# no page tables).
BACKENDS = ("brute", "bvh", "cuda")


@dataclasses.dataclass(frozen=True)
class SceneShard:
    """One rank's chunk: ``scene`` (``SceneTensors``, one instance), its
    index ``shard`` of ``n_shards``, and ``stride``, the global id of its
    first triangle row divided by ``shard``."""

    scene: object
    shard: int
    n_shards: int
    stride: int

    def to(self, device) -> "SceneShard":
        return dataclasses.replace(self, scene=self.scene.to(device))


def shard_compile(scene, n_shards: int, device="cuda", **compile_kw) -> list[SceneShard]:
    """Flatten ``scene``, split the merged triangles into ``n_shards``
    contiguous chunks and compile each resident (``compile_kw`` goes to
    ``Scene.compile``, with ``auto_page=False``): the chunks on
    ``device``, shard 0 first. A
    degenerate trailing chunk takes the last real triangle. Every chunk's
    4-wide tables report the largest ``max_leaf`` of any. Host work, once
    per scene; a rank keeps ``shards[rank]`` (``SceneShard.to`` moves it to
    its device)."""
    from ..scene.instance import MeshInstance
    from ..scene.mesh import MeshPrimitive
    from ..scene.scene import Scene

    flat, tri_mat = scene.flattened()
    merged = flat.meshes[0]
    total = merged.num_triangles
    if total < n_shards:
        raise ValueError(f"fewer triangles ({total}) than shards ({n_shards})")
    per = -(-total // n_shards)
    chunks = []
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, total)
        if lo >= hi:
            lo, hi = total - 1, total
        sl = slice(lo, hi)
        kw = {}
        if merged.vn0 is not None:
            kw = dict(vn0=merged.vn0[sl], vn1=merged.vn1[sl], vn2=merged.vn2[sl],
                      vn_mask=merged.vn_mask[sl])
        mp = MeshPrimitive.from_triangles(merged.v0[sl], merged.v1[sl], merged.v2[sl],
                                          merged.normal[sl], merged.uv0[sl], merged.uv1[sl],
                                          merged.uv2[sl], **kw)
        chunk = Scene()
        chunk.materials = flat.materials
        chunk.sky_texture = scene.sky_texture
        chunk.add_mesh(mp)
        chunk.add_mesh_instance(MeshInstance(0, 0))
        chunks.append(chunk.compile(device, auto_page=False,
                                    _tri_mat=tri_mat[sl][mp.bvh.order], **compile_kw))
    max_leaf = max(c.wide4.max_leaf for c in chunks)
    stride = max(c.num_triangles for c in chunks)
    return [SceneShard(dataclasses.replace(c, wide4=dataclasses.replace(c.wide4,
                                                                        max_leaf=max_leaf)),
                       s, n_shards, stride) for s, c in enumerate(chunks)]


def _check(group: Group, shard: SceneShard, backend: str) -> None:
    if shard.n_shards != group.world_size:
        raise ValueError(f"{shard.n_shards} chunks for {group.world_size} ranks")
    if shard.shard != group.rank:
        raise ValueError(f"rank {group.rank} holds chunk {shard.shard}")
    if backend not in BACKENDS:
        raise ValueError(f"scene-sharded casts take the {', '.join(BACKENDS)} backends, "
                         f"not {backend!r}")


def _all_reduce(group: Group, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op``, in place: every
    collective of the combine goes through here."""
    dist.all_reduce(x, op=op, group=group.pg)
    return x


def _combine_hit(group: Group, hit: Hit, shard: int, stride: int, ints=None):
    """The lexicographic (t, global tri) minimum of every rank's ``hit``:
    (the combined ``Hit`` with global ids, -1 where every rank missed;
    ``winner``, True on the rank whose hit won; the sum over ranks of
    ``ints [..., k]`` masked to the winner, or None). ``t`` must be >= 0."""
    gtri = hit.tri.long() + shard * stride
    cand = torch.where(hit.tri >= 0, gtri, torch.full_like(gtri, _MISS_TRI))
    key = (hit.t.contiguous().view(torch.int32).long() << 32) | cand
    best = _all_reduce(group, key.clone(), dist.ReduceOp.MIN)
    t = (best >> 32).to(torch.int32).view(torch.float32)
    gtri_min = best & 0xFFFFFFFF
    miss = gtri_min >= _MISS_TRI
    # all-miss lanes tie on every rank: no winner there, so the masked
    # sums stay sums of one rank's values
    winner = (key == best) & ~miss
    packed = hit.inst.long()[..., None]
    if ints is not None:
        packed = torch.cat([packed, ints.long()], dim=-1)
    summed = _all_reduce(group, torch.where(winner[..., None], packed, 0), dist.ReduceOp.SUM)
    minus1 = torch.full_like(gtri_min, -1)
    out = Hit(t=t, tri=torch.where(miss, minus1, gtri_min).to(torch.int32),
              inst=torch.where(miss, minus1, summed[..., 0]).to(torch.int32))
    return out, winner, (summed[..., 1:] if ints is not None else None)


def _combined_occ(group: Group, local, backend: str):
    """The any-hit cast over every rank's chunk: occluded where any rank
    is (the minimum of the any-hit t)."""
    occ = occlusion_cast_fn(backend)

    def cast(_scene, o, d):
        h = occ(local, o.contiguous(), d.contiguous())
        return h._replace(t=_all_reduce(group, h.t.clone(), dist.ReduceOp.MIN))

    return cast


def _combined_nearest(group: Group, local, backend: str):
    """The nearest-hit distance over every rank's chunk (point-light
    visibility reads the true nearest t; tri and inst stay the rank's)."""
    near = get_cast_fn(backend)

    def cast(_scene, o, d):
        h = near(local, o.contiguous(), d.contiguous())
        return h._replace(t=_all_reduce(group, h.t.clone(), dist.ReduceOp.MIN))

    return cast


def _combined_cast_attrs(group: Group, shard: SceneShard, cast, config: RenderConfig):
    """``(o, d) -> HitAttributes`` of the nearest hit over every rank's
    chunk: the local cast and attributes, the hit combine, and each
    shading input summed with the winner's value alone."""
    local = shard.scene

    def cast_attrs(o, d):
        o, d = o.contiguous(), d.contiguous()
        hit = cast(local, o, d)
        attrs = hit_attributes(local, o, d, hit, exact=config.exact_math,
                               normal_mode=config.normal_mode)
        combined, winner, mat = _combine_hit(group, hit, shard.shard, shard.stride,
                                             attrs.material[..., None])
        floats = torch.cat([attrs.location, attrs.normal, attrs.uv], dim=-1)
        floats = _all_reduce(group, torch.where(winner[..., None], floats, 0.0),
                             dist.ReduceOp.SUM)
        return HitAttributes(hit=combined.t < FLT_MAX, t=combined.t,
                             location=floats[..., 0:3], normal=floats[..., 3:6],
                             uv=floats[..., 6:8], material=mat[..., 0],
                             inst=combined.inst.long())

    return cast_attrs


def _hooks(group: Group, shard: SceneShard, config: RenderConfig) -> dict:
    local = shard.scene
    return {"cast_attrs": _combined_cast_attrs(
                group, shard, get_cast_fn(config.backend, want_normals=True), config),
            "occ": _combined_occ(group, local, config.backend),
            "nearest": _combined_nearest(group, local, config.backend)}


def cast_rays_scene_sharded(group: Group, shard: SceneShard, origin, directions,
                            backend: str = "bvh") -> Hit:
    """The nearest hit over the whole scene, each rank casting against its
    chunk: t, global triangle ids (``shard * stride + row``) and the
    instance (0; -1 on a miss), the same on every rank."""
    _check(group, shard, backend)
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape).contiguous()
    hit = get_cast_fn(backend)(shard.scene, origin, directions.contiguous())
    return _combine_hit(group, hit, shard.shard, shard.stride)[0]


def _rays(config: RenderConfig, shard: SceneShard, K_inv, D, pose, inv_pose):
    dev = shard.scene.device
    return generate_rays(config.width, config.height, K_inv.to(dev), D.to(dev), pose.to(dev),
                         inv_pose.to(dev), exact=config.exact_math)


def render_image_scene_sharded(config: RenderConfig, group: Group, shard: SceneShard, K_inv,
                               D, pose, inv_pose) -> torch.Tensor:
    """A primary frame with the geometry split over ``group``: uint8 [H,
    W, 3] on every rank. Shadow rays (``lambert_shadow``) and point lights
    see the whole scene through the combined casts."""
    check_sharded_config(config)
    _check(group, shard, config.backend)
    origin, directions = _rays(config, shard, K_inv, D, pose, inv_pose)
    local = shard.scene
    cast = get_cast_fn(config.backend, want_normals=config.lighting != "flat")
    attrs = _combined_cast_attrs(group, shard, cast, config)(
        origin.expand(directions.shape), directions)
    return shade_primary(local, attrs, config.light_direction, config.lighting,
                         exact=config.exact_math, backend=config.backend, directions=directions,
                         point_lights=config.point_lights, tex_filter=config.texture_filter,
                         cast_fn=_combined_occ(group, local, config.backend),
                         nearest_cast_fn=_combined_nearest(group, local, config.backend))


def render_image_whitted_scene_sharded(config: RenderConfig, group: Group, shard: SceneShard,
                                       K_inv, D, pose, inv_pose, max_bounces: int = 2,
                                       shadows: bool = True) -> torch.Tensor:
    """Whitted reflections with the geometry split over ``group``: every
    bounce's nearest cast and every shadow cast is the combined one, so
    reflections see the whole scene."""
    check_sharded_config(config)
    _check(group, shard, config.backend)
    origin, directions = _rays(config, shard, K_inv, D, pose, inv_pose)
    return whitted_rays(config, shard.scene, origin, directions, max_bounces, shadows,
                        _sharded_hooks=_hooks(group, shard, config))


def render_image_path_scene_sharded(config: RenderConfig, group: Group, shard: SceneShard,
                                    K_inv, D, pose, inv_pose, key: torch.Tensor,
                                    max_bounces: int = 3, samples: int = 4) -> torch.Tensor:
    """Path tracing with the geometry split over ``group``: the path
    integrator with every cast combined, its bounce casts unsorted. Every
    rank draws the same samples from ``key``."""
    check_sharded_config(config, path=True)
    _check(group, shard, config.backend)
    origin, directions = _rays(config, shard, K_inv, D, pose, inv_pose)
    radiance = render_path_traced(shard.scene, origin, directions, key.to(directions.device),
                                  max_bounces=max_bounces, samples=samples,
                                  _sharded_hooks=_hooks(group, shard, config),
                                  **path_options(config))
    return to_u8(tonemap(radiance, config.tonemap, config.exposure))


def _check_frame(path: bool):
    def check(config: RenderConfig, group: Group, shard: SceneShard) -> None:
        check_sharded_config(config, path=path)
        _check(group, shard, config.backend)

    return check


compiled_render_image_scene_sharded = CompiledSharded(
    render_image_scene_sharded, _check_frame(False), collectives=True)
compiled_render_image_whitted_scene_sharded = CompiledSharded(
    render_image_whitted_scene_sharded, _check_frame(False), collectives=True)
compiled_render_image_path_scene_sharded = CompiledSharded(
    render_image_path_scene_sharded, _check_frame(True), collectives=True)
