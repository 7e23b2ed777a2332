"""Hit records, the brute-force oracle, hit attributes and backend choice.

Counterpart of ``tpu_raytracer/render/renderer.py``. Every cast returns
the compact ``Hit`` (t, tri, inst); ``hit_attributes`` rebuilds the
shading inputs (world location, normal, uv, material) from it.

Backends: ``brute`` (the oracle, every triangle against every ray),
``bvh`` (kernel K2, the binary BVH walk, through
``kernels/binary.cast_rays_binary_cuda``: the JAX package's ``bvh``
backend and its binary packet kernel), ``cuda`` (kernels K1 and K3
through ``kernels/traversal.cast_rays``), ``paged`` (K4 on 4-wide page
tables, K5 on binary ones) and ``paged_major`` (K6); on CPU tensors the
kernel backends run their plain versions. The paged backends use the
scene's page tables, attached once with ``SceneTensors.with_paging``
(``paged_major`` needs 4-wide ones), and raise on a scene without them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import transforms as T
from ..core.vecmath import FLT_MAX, dot, normalize
from .intersect import (
    bary_interp,
    barycentric_uv,
    point_in_triangle_uv,
    ray_plane_hit,
)

# Triangles tested per step of the brute cast: bounds its [rays, tris]
# intermediates.
BRUTE_TRI_CHUNK = 2048


class Hit(NamedTuple):
    """Per-ray hit: ``t`` world distance (FLT_MAX on a miss), ``tri`` and
    ``inst`` indices (-1 on a miss)."""

    t: torch.Tensor
    tri: torch.Tensor
    inst: torch.Tensor


class HitAttributes(NamedTuple):
    hit: torch.Tensor  # [...] bool
    t: torch.Tensor  # [...] f32 world distance
    location: torch.Tensor  # [..., 3] world hit point
    normal: torch.Tensor  # [..., 3] world unit normal
    uv: torch.Tensor  # [..., 2]
    material: torch.Tensor  # [...] i64
    inst: torch.Tensor  # [...] i64


def _instance_object_ray(scene, i, origin, direction):
    """World ray -> object space of instance ``i``."""
    rot = scene.inst_pose[i, 3:6]
    inv_scale = scene.inst_inv_scale[i]
    obj_dir = T.apply_euler(rot, direction) * inv_scale
    obj_org = T.apply_lre(scene.inst_pose[i], origin) * inv_scale
    return obj_org, obj_dir


def cast_rays_brute(scene, origin, directions, tri_chunk: int = BRUTE_TRI_CHUNK) -> Hit:
    """All-triangles nearest hit, the test oracle. Ties keep the lowest
    triangle index, like the JAX argmin."""
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape)
    shape = directions.shape[:-1]
    d_all = directions.reshape(-1, 3)
    o_all = origin.reshape(-1, 3)
    dev = d_all.device
    t_best = torch.full(d_all.shape[:1], FLT_MAX, dtype=torch.float32, device=dev)
    tri_best = torch.full(d_all.shape[:1], -1, dtype=torch.int32, device=dev)
    in_best = torch.full(d_all.shape[:1], -1, dtype=torch.int32, device=dev)
    for i in range(scene.num_instances):
        obj_org, obj_dir = _instance_object_ray(scene, i, o_all, d_all)
        o = obj_org[:, None, :]
        d = obj_dir[:, None, :]
        for lo in range(0, scene.num_triangles, tri_chunk):
            sl = slice(lo, lo + tri_chunk)
            v0, n = scene.tri_v0[sl], scene.tri_normal[sl]
            t, _, valid = ray_plane_hit(o, d, v0, n)
            _, inside = point_in_triangle_uv(
                o, d, t, v0, scene.tri_v1[sl], scene.tri_v2[sl],
                scene.tri_uv0[sl], scene.tri_uv1[sl], scene.tri_uv2[sl],
            )
            backface = dot(d, n) < 0.0
            in_mesh = scene.tri_mesh[sl] == scene.inst_mesh[i]
            dist = torch.where(valid & inside & backface & in_mesh, t,
                               torch.full_like(t, FLT_MAX))
            dj, j = dist.min(dim=1)
            better = dj < t_best
            t_best = torch.where(better, dj, t_best)
            tri_best = torch.where(better, (j + lo).to(torch.int32), tri_best)
            in_best = torch.where(better, torch.full_like(in_best, i), in_best)
    return Hit(t=t_best.reshape(shape), tri=tri_best.reshape(shape),
               inst=in_best.reshape(shape))


def hit_attributes(scene, origin, directions, hit: Hit, exact: bool = True,
                   normal_mode: str = "reference") -> HitAttributes:
    """Shading inputs from (t, tri, inst): re-runs the plane and
    barycentric math for the selected triangle of each ray and maps the
    point and normal to world space. The normal follows the JAX
    package's ``normal_mode="reference"`` (rotated, then multiplied by
    the instance scale) and is normalised exactly or, with ``exact``
    False, by ``q_rsqrt``; the inverse-transpose mode is not ported yet
    (ROADMAP item 8)."""
    if normal_mode != "reference":
        raise NotImplementedError(
            f"normal_mode={normal_mode!r} is not ported yet (ROADMAP item 8)")
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape)
    ok = hit.t < FLT_MAX
    tri = torch.clamp(hit.tri, min=0).long()
    inst = torch.clamp(hit.inst, min=0).long()

    ipack = torch.cat([scene.inst_pose, scene.inst_inv_pose, scene.inst_scale,
                       scene.inst_inv_scale], dim=1)
    irec = ipack[0] if scene.num_instances == 1 else ipack[inst]
    inst_pose = irec[..., 0:6]
    inst_inv_pose = irec[..., 6:12]
    scale = irec[..., 12:15]
    inv_scale = irec[..., 15:18]

    obj_dir = T.apply_euler(inst_pose[..., 3:6], directions) * inv_scale
    obj_org = T.apply_lre(inst_pose, origin) * inv_scale

    tv0 = scene.tri_v0[tri]
    tnormal = scene.tri_normal[tri]
    tp, point, _ = ray_plane_hit(obj_org, obj_dir, tv0, tnormal)
    u_b, v_b = barycentric_uv(obj_org, obj_dir, tp, tv0, scene.tri_v1[tri],
                              scene.tri_v2[tri])
    uv = bary_interp(u_b, v_b, scene.tri_uv0[tri], scene.tri_uv1[tri],
                     scene.tri_uv2[tri])
    location = T.apply_lre(inst_inv_pose, point * scale)
    normal = normalize(T.apply_euler(inst_inv_pose[..., 3:6], tnormal) * scale,
                       exact=exact)
    tmat = scene.tri_mat[tri].long()
    imat = scene.inst_material.long()
    imat = imat[0] if scene.num_instances == 1 else imat[inst]
    material = torch.where(tmat >= 0, tmat, imat)
    return HitAttributes(hit=ok, t=hit.t, location=location, normal=normal,
                         uv=uv, material=material, inst=inst)


def occlusion_cast_fn(backend: str):
    """The any-hit cast for boolean shadow queries (occluded iff t <
    FLT_MAX): on ``cuda`` and ``bvh``, the any-hit mode of K1/K3 or K2,
    which stops a ray at its first accepted triangle; the other backends
    return their nearest-hit cast, which gives the same answer (the
    paged kernels, like the JAX package's, have no any-hit mode)."""
    cast = get_cast_fn(backend)
    if backend in ("cuda", "bvh"):
        return functools.partial(cast, occlusion=True)
    return cast


BACKENDS = ("brute", "bvh", "cuda", "paged", "paged_major")


def get_cast_fn(backend: str):
    """The nearest-hit cast of ``backend``: ``brute``, ``bvh``, ``cuda``,
    ``paged`` or ``paged_major``."""
    if backend == "brute":
        return cast_rays_brute
    if backend == "bvh":
        from ..kernels.binary import cast_rays_binary_cuda

        return cast_rays_binary_cuda
    if backend == "cuda":
        from ..kernels.traversal import cast_rays

        return cast_rays
    if backend == "paged":
        from ..kernels.paged import cast_rays_paged_cuda

        return cast_rays_paged_cuda
    if backend == "paged_major":
        from ..kernels.paged_major import cast_rays_paged_major_cuda

        return cast_rays_paged_major_cuda
    raise NotImplementedError(
        f"backend {backend!r} is not ported; the port has {', '.join(BACKENDS)}")
