"""Two-level casts for scenes of two or more instances: the TLAS tables,
kernel K3, and its plain PyTorch version.

Counterpart of ``tpu_raytracer/kernels/tlas.py``: a binary BVH over the
instances' world-space boxes (the TLAS) is walked nearest instance
first; reaching a leaf walks that instance's 4-wide BLAS in object
space, with one shared ``t`` per ray, so a close hit culls the farther
instances at their TLAS box.

  * ``build_tlas`` builds the tables on the host, as the JAX build does;
    ``Scene.compile`` and ``from_scene_arrays`` attach them to scenes of
    two or more instances, and ``SceneTensors.update_instance`` rebuilds
    them after a pose change.
  * ``cast_rays_tlas_cuda`` is K3's wrapper: for CUDA tensors it launches
    the hand-written kernel (``csrc/tlas_traverse.cu``, K1's walk of
    ``csrc/walk.cuh`` under the TLAS walk, one stack for both) and counts the
    launch in ``build.LAUNCHES`` (``K3``, ``K3_carry``); for CPU tensors it
    calls the plain version. A
    CUDA tensor never reaches the plain version and a failed build or
    launch raises.
  * ``cast_rays_tlas_torch`` is the plain version: the same two-level
    walk vectorised over rays (a per-ray TLAS stack; rays grouped by the
    instance they reach, then K1's plain BLAS walk), in the kernel's
    visit order, so the two agree bit for bit in ``t``, ``tri`` and
    ``inst``, and in the carried ``u``, ``v`` and ``n``
    (``traversal.carry_fields``; K3's carrying kernel).

At an exact-``t`` tie between two instances, ``tri``/``inst`` follow
the TLAS's spatial visit order, which may differ from the brute cast's
instance order; ``t`` never differs (``tpu_raytracer/kernels/tlas.py``
tie note).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..core import transforms as T
from ..render.intersect import safe_reciprocal
from .traversal import (
    BIG,
    LEAF_BITS,
    MAX_LEAF_TRIS,
    PLAIN_CHUNK,
    _split_rays,
    _wide_tables,
    carried,
    carry_fields,
    check_carry,
    child_entry,
    finish_plain,
    instance_table,
    launch,
    new_carry,
    new_stats,
    walk_instance,
)
from .build import check_inputs
from .wide4 import NUDGE, STACK_SIZE, stack_needed

# per-ray TLAS stack of the plain walk and the deepest TLAS build_tlas
# makes; the kernel keeps TLAS entries in its one stack (csrc/walk.cuh)
TLAS_STACK = 48

@dataclasses.dataclass(frozen=True)
class TlasTables:
    """The TLAS in a layout for one thread per ray."""

    code: torch.Tensor  # [Nt] i32: internal -> child b (child a = node + 1); leaf -> -(start*1024+count)-1
    box: torch.Tensor  # [Nt, 12] f32: child a's box, child b's box (min xyz, max xyz, NUDGE baked in)
    inst_ids: torch.Tensor  # [I] i32: leaf position -> instance id
    depth: int  # nodes on the longest root-to-leaf path

    def to(self, device) -> "TlasTables":
        return dataclasses.replace(self, code=self.code.to(device), box=self.box.to(device),
                                   inst_ids=self.inst_ids.to(device))


def _depth(code: np.ndarray) -> int:
    depth, level = 0, np.array([0])
    while level.size:
        depth += 1
        c = code[level]
        inner = level[c >= 0]
        level = np.concatenate([inner + 1, c[c >= 0]])
    return depth


def build_tlas(scene) -> TlasTables:
    """Host build: each instance's world box is its mesh root box's 8
    corners mapped to world space (``apply_lre(inv_pose, corner *
    scale)``, conservative: it includes the compile-time box pad), then
    the SAH builder over those boxes with leaves of one."""
    mr = scene.mesh_root[scene.inst_mesh.long()].long()
    bmin = scene.node_min[mr].cpu().numpy()  # [I, 3] object-space root box
    bmax = scene.node_max[mr].cpu().numpy()
    sel = np.array([[(c >> a) & 1 for a in range(3)] for c in range(8)], np.float32)
    corners = bmin[:, None, :] * (1.0 - sel) + bmax[:, None, :] * sel
    world = T.apply_lre(scene.inst_inv_pose.cpu()[:, None, :],
                        torch.from_numpy(corners) * scene.inst_scale.cpu()[:, None, :]).numpy()
    wmin = world.min(axis=1).astype(np.float32)
    wmax = world.max(axis=1).astype(np.float32)
    # the builder grows node boxes over its three "vertex" arrays, so
    # (min corner, max corner, center) gives exact box unions with
    # centroid splits at box centers; the reference search gives the JAX
    # package's TLAS
    bvh = build_bvh(wmin, wmax, (wmin + wmax) * 0.5, max_depth=32, min_leaf_size=1,
                    mode="reference")
    if bvh.leaf_count.max(initial=0) > MAX_LEAF_TRIS:
        raise ValueError("TLAS leaf exceeds the 10-bit count field")
    internal = bvh.child_a >= 0
    idx = np.nonzero(internal)[0]
    if not (bvh.child_a[idx] == idx + 1).all():
        raise ValueError("TLAS not DFS preorder")
    packed_leaf = bvh.leaf_start * (1 << LEAF_BITS) + bvh.leaf_count
    code = np.where(internal, bvh.child_b, -packed_leaf - 1).astype(np.int32)
    depth = _depth(code)
    if depth >= TLAS_STACK:
        raise ValueError(f"TLAS depth {depth} exceeds the kernel's {TLAS_STACK}-slot stack")
    ca = np.maximum(bvh.child_a, 0)
    cb = np.maximum(bvh.child_b, 0)
    nudge = np.float32(NUDGE)
    box = np.concatenate([bvh.node_min[ca] - nudge, bvh.node_max[ca] + nudge,
                          bvh.node_min[cb] - nudge, bvh.node_max[cb] + nudge], axis=1)
    dev = scene.device
    return TlasTables(
        code=torch.from_numpy(code).to(dev),
        box=torch.from_numpy(np.ascontiguousarray(box, np.float32)).to(dev),
        inst_ids=torch.from_numpy(bvh.order.astype(np.int32)).to(dev),
        depth=depth,
    )


def _tlas_tables(scene) -> TlasTables:
    if scene.tlas is None:
        raise ValueError("scene has no TLAS (scenes of one instance have none)")
    return scene.tlas


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _walk_tlas(tables, tl, inst_tab, roots, o, d, best, stats=None, carry=None):
    """Two-level walk of rays ``o``/``d`` [n, 3], updating ``best`` = [t,
    tri, inst] (and ``carry`` = (u, v, n), ``walk_tree``'s) in place.
    Each round pops every live ray's TLAS stack
    down to its next leaf (internal nodes push their hit children, the
    nearer last), then walks that leaf's instances in ``inst_ids`` order
    for the rays that reached it, grouped by instance. ``stats``
    (``traversal.new_stats``) counts internal TLAS pops as top pops."""
    t_b, tri_b, in_b = best
    n = d.shape[0]
    dev = d.device
    inv = safe_reciprocal(d)
    code_t = tl.code.long()
    stack = torch.zeros((n, TLAS_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    while True:
        leaf = torch.full((n,), -1, dtype=torch.int64, device=dev)
        while True:
            idx = torch.nonzero((sp > 0) & (leaf < 0)).squeeze(1)
            if idx.numel() == 0:
                break
            spn = sp[idx] - 1
            node = stack[idx, spn]
            code = code_t[node]
            internal = code >= 0
            leaf[idx] = torch.where(internal, -1, node)
            if stats is not None:
                stats["top_pops"][idx] += internal.long()
            dist = child_entry(tl.box[node].reshape(-1, 2, 6), o[idx][:, None, :],
                               inv[idx][:, None, :], t_b[idx][:, None])
            da, db = dist[:, 0], dist[:, 1]
            a_near = da <= db
            ca = node + 1
            # the farther child is pushed first, the nearer last
            for child, pushed in (
                (torch.where(a_near, code, ca), torch.where(a_near, db, da) < BIG),
                (torch.where(a_near, ca, code), torch.where(a_near, da, db) < BIG),
            ):
                push = internal & pushed
                stack[idx, spn] = torch.where(push, child, stack[idx, spn])
                spn = spn + push.long()
            sp[idx] = spn
        rays = torch.nonzero(leaf >= 0).squeeze(1)
        if rays.numel() == 0:
            return
        packed = -code_t[leaf[rays]] - 1
        start = packed >> LEAF_BITS
        count = packed & MAX_LEAF_TRIS
        for p in range(int(count.max())):
            at = count > p
            ids = tl.inst_ids[start[at] + p].long()
            for i in torch.unique(ids).tolist():
                sub = rays[at][ids == i]
                part = (t_b[sub], tri_b[sub], in_b[sub])
                sub_stats = None if stats is None else {k: v[sub] for k, v in stats.items()}
                cpart = None if carry is None else tuple(x[sub] for x in carry)
                walk_instance(tables, inst_tab[i], roots[i], i, o[sub], d[sub], part, sub_stats,
                              cpart)
                t_b[sub], tri_b[sub], in_b[sub] = part
                if carry is not None:
                    for x, y in zip(carry, cpart):
                        x[sub] = y
                if stats is not None:
                    for k, v in sub_stats.items():
                        stats[k][sub] = v


def cast_rays_tlas_torch(scene, origin, directions, occlusion: bool = False,
                         chunk: int = PLAIN_CHUNK, stats: bool = False,
                         carry_uv: bool = False, carry_n: bool = False):
    """Plain PyTorch version of K3: nearest hit of every ray through the
    TLAS and the instances' 4-wide tables (any hit with ``occlusion``),
    with the carried u and v (``carry_uv``) and face normal (``carry_n``)
    where asked (K3's carrying kernel). With ``stats`` it returns ``(hit,
    counters)`` (``traversal.new_stats``, of the nearest-hit walk)."""
    check_carry(occlusion, carry_uv, carry_n)
    origin, directions = _split_rays(origin, directions)
    tables = _wide_tables(scene)
    tl = _tlas_tables(scene)
    shape = directions.shape[:-1]
    d_all = directions.reshape(-1, 3)
    o_all = origin.expand(directions.shape).reshape(-1, 3)
    inst_tab = instance_table(scene)
    roots = tables.wroot[scene.inst_mesh.long()].tolist()
    dev = d_all.device
    r = d_all.shape[0]
    t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    counters = new_stats(r, dev) if stats else None
    carry = new_carry(r, dev) if carry_uv or carry_n else None
    for lo in range(0, r, chunk):
        sl = slice(lo, min(lo + chunk, r))
        part = None if counters is None else {k: v[sl] for k, v in counters.items()}
        cpart = None if carry is None else tuple(x[sl] for x in carry)
        _walk_tlas(tables, tl, inst_tab, roots, o_all[sl], d_all[sl],
                   (t[sl], tri[sl], inst[sl]), part, cpart)
    return finish_plain(t, tri, inst, shape, scene.num_instances, occlusion, counters,
                        carried(carry, carry_uv, carry_n))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def check_stack(scene) -> None:
    """Raise unless K3's stack holds the scene's TLAS entries (at most
    one per level) below its BLAS walk's."""
    tl = _tlas_tables(scene)
    need = tl.depth + stack_needed(_wide_tables(scene).depth)
    if need > STACK_SIZE:
        raise ValueError(f"TLAS depth {tl.depth} with the BLAS's stack needs {need} "
                         f"stack slots; the kernel has {STACK_SIZE}")


def cast_rays_tlas_cuda(scene, origin, directions, occlusion: bool = False,
                        short_stack: int | None = None, want_normals: bool = False,
                        carry: bool | None = None):
    """K3: nearest (or, with ``occlusion``, any) hit through the TLAS,
    with the carried fields ``traversal.carry_fields`` gives for
    ``want_normals`` and ``carry`` (K3's carrying kernel). CUDA tensors
    launch the kernel on the current stream, with ``short_stack`` ring
    slots per thread (``traversal.launch``); CPU tensors run the plain
    version."""
    origin, directions = _split_rays(origin, directions)
    carry_uv, carry_n = carry_fields(scene, directions, occlusion, want_normals, carry)
    if directions.device.type == "cpu":
        return cast_rays_tlas_torch(scene, origin, directions, occlusion, carry_uv=carry_uv,
                                    carry_n=carry_n)
    tl = _tlas_tables(scene)
    check_inputs(directions.device, ("tlas code", tl.code, torch.int32),
                 ("tlas box", tl.box, torch.float32), ("tlas inst_ids", tl.inst_ids, torch.int32),
                 aligned=("tlas box",))
    check_stack(scene)
    return launch("tlas_launch", scene, origin, directions, occlusion,
                  (tl.code.data_ptr(), tl.box.data_ptr(), tl.inst_ids.data_ptr()),
                  short_stack=short_stack, carry_uv=carry_uv, carry_n=carry_n,
                  count=("K3",) + ("K3_carry",) * (carry_uv or carry_n))
