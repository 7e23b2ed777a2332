"""Hit records, the brute-force oracle, hit attributes and backend choice.

Counterpart of ``tpu_raytracer/render/renderer.py``. Every cast returns
the compact ``Hit`` (t, tri, inst, and u, v, n where K1 or K3 carried
them); ``hit_attributes`` rebuilds the shading inputs (world location,
normal, uv, material) from it, with kernel S2 on the card and its plain
version ``hit_attributes_torch`` on the CPU.

Backends: ``brute`` (the oracle, every triangle against every ray),
``bvh`` (kernel K2, the binary BVH walk, through ``cast_rays_bvh`` and
``kernels/binary.cast_rays_binary_cuda``: the JAX package's ``bvh``
backend and its binary packet kernel), ``cuda`` (kernels K1 and K3
through ``kernels/traversal.cast_rays``), ``paged`` (K4 on 4-wide page
tables, K5 on binary ones) and ``paged_major`` (K6); on CPU tensors the
kernel backends run their plain versions. A scene that needs paging
(``SceneTensors.needs_paging``) has no tables for K1-K3, and ``cuda`` and
``bvh`` cast it with K4 through its page tables
(``traversal.cast_rays_paged_route``). The paged backends use the
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
    ``inst`` indices (-1 on a miss). ``u``/``v`` (the accepted
    triangle's barycentrics) and ``n`` ([..., 3], its object-space face
    normal) are there where the cast carried them (K1 and K3 on the
    card, ``kernels/traversal.carry_fields``), else None;
    ``hit_attributes`` then skips the redo of the plane and barycentric
    math."""

    t: torch.Tensor
    tri: torch.Tensor
    inst: torch.Tensor
    u: torch.Tensor | None = None
    v: torch.Tensor | None = None
    n: torch.Tensor | None = None


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


NORMAL_MODES = ("reference", "inverse_transpose")


def hit_attributes(scene, origin, directions, hit: Hit, exact: bool = True,
                   normal_mode: str = "reference") -> HitAttributes:
    """Shading inputs from the hit record, mapped to world space
    (``hit_attributes_torch`` says how). CUDA tensors launch kernel S2
    (``kernels/frame.py hit_attributes_cuda``), CPU tensors take the plain
    version ``hit_attributes_torch``."""
    if torch.as_tensor(directions).device.type == "cpu":
        return hit_attributes_torch(scene, origin, directions, hit, exact, normal_mode)
    from ..kernels.frame import hit_attributes_cuda

    return hit_attributes_cuda(scene, origin, directions, hit, exact, normal_mode)


def hit_attributes_torch(scene, origin, directions, hit: Hit, exact: bool = True,
                         normal_mode: str = "reference") -> HitAttributes:
    """Shading inputs from the hit record, mapped to world space: the
    plain version of ``hit_attributes`` (and of kernel S2).

    Without carried fields it re-runs the plane and barycentric math for
    the selected triangle of each ray (the redo). With them (``hit.u``/
    ``hit.v`` and or ``hit.n``, the JAX package's carried branch) uv
    comes from one gather of the triangle's uv corners at the carried
    u, v, the plane point from ``hit.t`` and the normal from ``hit.n``
    (the record gather where n was not carried, the redo's uv where u
    was not). Scenes with vertex normals (``tri_vnorm``) interpolate them
    at the barycentrics where a triangle has them.

    ``normal_mode``: ``reference`` rotates the normal and multiplies it
    by the instance scale (the reference's rule, right for uniform scale
    only); ``inverse_transpose`` scales it by the inverse scale in object
    axes, then rotates (right under nonuniform scale). The normal is
    normalised exactly or, with ``exact`` False, by ``q_rsqrt``."""
    if normal_mode not in NORMAL_MODES:
        raise ValueError(f"unknown normal_mode {normal_mode!r}; one of {NORMAL_MODES}")
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

    if hit.u is not None or hit.n is not None:
        if hit.u is not None:
            u_b, v_b = hit.u, hit.v
            uv = bary_interp(u_b, v_b, scene.tri_uv0[tri], scene.tri_uv1[tri],
                             scene.tri_uv2[tri])
        # hit.t is the plane parameter of an accepted hit (the kernels'
        # t is ray_plane_hit's), so the plane redo drops; a miss keeps a
        # finite point at t = 0
        tp = torch.where(ok, hit.t, torch.zeros_like(hit.t))
        point = obj_org + tp[..., None] * obj_dir
        tnormal = hit.n if hit.n is not None else scene.tri_normal[tri]
        if hit.u is None:
            # normals carried on an untextured scene: uv by the redo
            u_b, v_b = barycentric_uv(obj_org, obj_dir, tp, scene.tri_v0[tri],
                                      scene.tri_v1[tri], scene.tri_v2[tri])
            uv = bary_interp(u_b, v_b, scene.tri_uv0[tri], scene.tri_uv1[tri],
                             scene.tri_uv2[tri])
    else:
        tv0 = scene.tri_v0[tri]
        tnormal = scene.tri_normal[tri]
        tp, point, _ = ray_plane_hit(obj_org, obj_dir, tv0, tnormal)
        u_b, v_b = barycentric_uv(obj_org, obj_dir, tp, tv0, scene.tri_v1[tri],
                                  scene.tri_v2[tri])
        uv = bary_interp(u_b, v_b, scene.tri_uv0[tri], scene.tri_uv1[tri],
                         scene.tri_uv2[tri])
    if scene.tri_vnorm is not None:
        # smooth normals: the corners' vertex normals at the barycentrics
        # where the triangle's face had them (lane 9), else the face normal
        vrec = scene.tri_vnorm[tri]
        n_int = bary_interp(u_b, v_b, vrec[..., 0:3], vrec[..., 3:6], vrec[..., 6:9])
        smooth = (vrec[..., 9] > 0) & ok
        tnormal = torch.where(smooth[..., None], n_int, tnormal)
    location = T.apply_lre(inst_inv_pose, point * scale)
    if normal_mode == "inverse_transpose":
        # (R diag(s))^-T = R diag(1/s): scale in object axes, then rotate
        normal = normalize(T.apply_euler(inst_inv_pose[..., 3:6], tnormal * inv_scale),
                           exact=exact)
    else:
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
    which stops a ray at its first accepted triangle (on a scene that
    needs paging, K4's nearest hit as an any-hit record); the other
    backends return their nearest-hit cast, which gives the same answer
    (the paged kernels, like the JAX package's, have no any-hit mode)."""
    cast = get_cast_fn(backend)
    if backend in ("cuda", "bvh"):
        return functools.partial(cast, occlusion=True)
    return cast


BACKENDS = ("brute", "bvh", "cuda", "paged", "paged_major")


def cast_rays_bvh(scene, origin, directions, occlusion: bool = False,
                  t_max: float | None = None):
    """The cast of the ``bvh`` backend: K2 (``kernels/binary.py``),
    bounded by ``t_max`` (None: unbounded), or for a scene that needs
    paging the ``cuda`` backend's paged route
    (``traversal.cast_rays_paged_route``, which ignores the bound): the
    JAX ``bvh`` backend walks any scene, and K2's leaf codes cannot
    address such a one."""
    from ..kernels.binary import cast_rays_binary_cuda
    from ..kernels.traversal import BIG, cast_rays_paged_route, needs_paging

    if needs_paging(scene):
        return cast_rays_paged_route(scene, origin, directions, occlusion)
    return cast_rays_binary_cuda(scene, origin, directions, occlusion,
                                 t_max=BIG if t_max is None else t_max)


def get_cast_fn(backend: str, want_normals: bool = False, t_max: float | None = None):
    """The nearest-hit cast of ``backend``: ``brute``, ``bvh``, ``cuda``,
    ``paged`` or ``paged_major``. ``want_normals``: the caller's shading
    reads normals, and the ``cuda`` cast then carries the face normal on
    ``Hit.n`` (K1's and K3's carry; on CUDA tensors); the other backends
    ignore it. ``t_max``: the caller asks only about hits nearer than it,
    and the ``cuda`` and ``bvh`` casts then bound K1's and K2's walks by it
    (a hit beyond comes back a miss); the other backends and kernels
    ignore it, so a hit nearer than ``t_max`` keeps its t on every
    backend."""
    if backend == "brute":
        return cast_rays_brute
    if backend == "bvh":
        return cast_rays_bvh if t_max is None else functools.partial(cast_rays_bvh, t_max=t_max)
    if backend == "cuda":
        from ..kernels.traversal import cast_rays

        kw = {"want_normals": True} if want_normals else {}
        if t_max is not None:
            kw["t_max"] = t_max
        return functools.partial(cast_rays, **kw) if kw else cast_rays
    if backend == "paged":
        from ..kernels.paged import cast_rays_paged_cuda

        return cast_rays_paged_cuda
    if backend == "paged_major":
        from ..kernels.paged_major import cast_rays_paged_major_cuda

        return cast_rays_paged_major_cuda
    raise NotImplementedError(
        f"backend {backend!r} is not ported; the port has {', '.join(BACKENDS)}")
