"""Casts over the 4-wide BVH: kernel K1, its plain PyTorch version, and
the router.

Counterpart of ``tpu_raytracer/kernels/traversal.py:cast_rays_pallas``
(the router) and ``kernels/dual.py:cast_rays_dual`` (the wide kernel it
routes single-instance scenes to).

  * ``cast_rays_cuda`` is K1's wrapper: for CUDA tensors it launches
    the hand-written kernel (``csrc/wide_traverse.cu``, the walk of
    ``csrc/walk.cuh`` over the node records ``wnode``) and counts the
    launch in ``build.LAUNCHES`` (``K1``, ``K1_carry``, ``K1_bounded``);
    for CPU tensors it calls the plain version.
    A CUDA tensor never reaches the plain version and a failed build or
    launch raises.
  * ``cast_rays_wide_torch`` is the plain version: the same per-ray
    stack walk over the same tables, vectorised over rays — same child
    ranking, same leaf order, same f32 operation order as the kernel, so
    the two agree bit for bit. ``cast_rays_tree_torch`` is that walk at
    either arity; at arity 2 it is the plain version of K2
    (``kernels/binary.py``), and ``launch`` launches K2 too.
  * ``cast_rays`` is the router of the ``cuda`` backend, in the JAX
    router's order: a scene that needs paging (``needs_paging``: its
    triangle rows reach ``PAGING_ROWS``, the leaf code's limit) goes
    to the paged kernel K4 through its page tables
    (``cast_rays_paged_route``, which the ``bvh`` backend takes for such
    a scene too); then scenes with two or more instances and a TLAS go to
    K3 (``kernels/tlas.py``), every other scene to K1. The paged kernels
    K4-K6 (``kernels/paged.py``, ``kernels/paged_major.py``) are also the
    ``paged`` and ``paged_major`` backends, which force them on any
    scene with page tables.

Every cast returns the JAX package's hit record: ``t`` (FLT_MAX on a
miss), ``tri`` and ``inst`` (-1 on a miss), and the carried fields where
the cast carries them (``carry_fields``: the accepted triangle's
barycentric ``u`` and ``v`` on textured scenes, its object-space face
normal ``n`` where the caller reads normals; K1 and K3 in nearest mode
only, the JAX package's ``make_test_tri`` ``carry_uv``/``carry_n``).
With ``occlusion=True`` it
is the any-hit record of shadow rays (``make_test_tri``'s occlusion
mode): ``t`` is -BIG where the ray is blocked and FLT_MAX where it is
clear; ``tri``/``inst`` carry no meaning. The kernels stop a ray at its
first accepted triangle; the plain versions map the nearest hit, which
gives the same answer because boxes are conservative.

K1 and K2 (and their plain versions) take a bound ``t_max`` (default
BIG, unbounded): each ray's walk starts its best hit there, so it pops no
box it enters past the bound and reports only hits nearer than it; a ray
with none is a miss (``csrc/walk.cuh`` says what else holds). A caller
whose question is whether anything lies within a distance (AO) passes
that distance.
"""

from __future__ import annotations

import torch

from ..accel import wide
from ..core import transforms as T
from ..core.vecmath import FLT_MAX
from ..render.intersect import EDGE_EPS, PARALLEL_EPS, safe_reciprocal
from . import build
from .wide4 import SHORT_STACK, STACK_SIZE

BIG = 3.0e38  # initial t_best; never a hit distance
# Boxes are culled against t_best times this (8 ulps): csrc/wide_traverse.cuh
# kCapSlack says why.
CAP_SLACK = 1.0 + 2.0 ** -20
LEAF_BITS = wide.LEAF_BITS
MAX_LEAF_TRIS = (1 << LEAF_BITS) - 1

# Rays the plain walk handles at once: bounds its [rays, leaf, 16]
# record gathers to a few hundred MB at the flagship's 2M rays.
PLAIN_CHUNK = 1 << 18

def _hit(t, tri, inst, shape, carry=None):
    """The Hit record of flat outputs, with the carried (u, v, n) where
    ``carry`` holds them (None for a field not carried)."""
    from ..render.renderer import Hit  # local: renderer imports this module

    u, v, n = carry if carry is not None else (None, None, None)
    shaped = lambda x, tail=(): None if x is None else x.reshape(shape + tail)
    return Hit(t=t.reshape(shape), tri=tri.reshape(shape), inst=inst.reshape(shape),
               u=shaped(u), v=shaped(v), n=shaped(n, (3,)))


def carry_fields(scene, directions, occlusion: bool, want_normals: bool = False,
                 carry: bool | None = None) -> tuple[bool, bool]:
    """(carry_uv, carry_n) of a K1 or K3 cast, gated as the JAX package
    gates its TPU kernels (``dual.py:927-943``, ``tlas.py:666-673``): u
    and v on textured scenes, n where the caller reads normals
    (``want_normals``), neither for any hit. ``carry`` None turns the
    carry on for CUDA tensors and off for CPU ones (the JAX package's
    interpret default, which keeps the CPU goldens on the redo path of
    ``hit_attributes``); True or False forces it."""
    on = directions.device.type == "cuda" if carry is None else bool(carry)
    on = on and not occlusion
    return on and bool(scene.has_textures), on and want_normals


def instance_table(scene) -> torch.Tensor:
    """[I, 12] f32 per-instance rows: quaternion (w, x, y, z) of the
    pose's euler angles, position, inverse scale, 2 zero lanes."""
    quat = T.euler2quat(scene.inst_pose[:, 3:6])
    pad = torch.zeros(scene.num_instances, 2, dtype=torch.float32,
                      device=scene.device)
    return torch.cat(
        [quat, scene.inst_pose[:, 0:3], scene.inst_inv_scale, pad], dim=1
    ).contiguous()


def _wide_tables(scene):
    if scene.wide4 is None:
        raise NotImplementedError(
            "scene has no 4-wide tables: only a scene that needs paging "
            "(SceneTensors.needs_paging) lacks them, and it is cast through its page "
            "tables by K4 (cast_rays), or the 'paged' and 'paged_major' backends")
    return scene.wide4


def _split_rays(origin, directions):
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32)
    if origin.device != directions.device:
        raise ValueError(f"origin on {origin.device}, directions on {directions.device}")
    if directions.shape[-1] != 3:
        raise ValueError(f"directions must be [..., 3], got {tuple(directions.shape)}")
    if origin.shape != (3,) and origin.shape != directions.shape:
        raise ValueError(
            f"origin must be [3] or match directions {tuple(directions.shape)}, "
            f"got {tuple(origin.shape)}")
    return origin, directions


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def child_entry(box, o, inv, t_cap):
    """Slab entry distance of boxes ``box [..., 6]`` (min xyz, max xyz)
    for rays whose best hit is at ``t_cap``, BIG on a miss. The kernels'
    ``slab_entry`` (``csrc/walk.cuh``) computes it with the same f32
    operations in the same order."""
    t1 = (box[..., 0:3] - o) * inv
    t2 = (box[..., 3:6] - o) * inv
    fmn = torch.fmin(t1, t2)
    fmx = torch.fmax(t1, t2)
    near = torch.maximum(torch.maximum(fmn[..., 0], fmn[..., 1]), fmn[..., 2])
    far = torch.minimum(torch.minimum(fmx[..., 0], fmx[..., 1]), fmx[..., 2])
    hit = (far >= near) & (far > 0.0) & (near < t_cap * CAP_SLACK)
    return torch.where(hit, near, torch.full_like(near, BIG))


def box_stride(arity: int) -> int:
    """Floats per row of the ``box`` table of a tree of ``arity``: the
    4-wide tables keep 32 (24 box floats and 8 zero lanes), the binary
    ones 12."""
    return 32 if arity == 4 else 6 * arity


def object_ray(q, o, d):
    """World rays ``o``/``d`` [n, 3] in the object space of the instance
    whose row of ``instance_table`` is ``q``: (origin, direction, safe
    reciprocal direction), ``object_ray`` of ``csrc/wide_traverse.cuh``."""
    s = q[7:10]
    od = T.apply_quat(q[0:4], d) * s
    oo = T.apply_quat(q[0:4], o - q[4:7]) * s
    return oo, od, safe_reciprocal(od)


def new_stats(n: int, device) -> dict:
    """Per-ray visit counters of the plain walks: ``pops`` (nodes of a
    BVH or page tree popped), ``top_pops`` (internal TLAS or top-tree
    nodes popped, two child boxes each) and ``tests`` (triangles
    tested). They mirror the JAX package's kernel-stats
    counters; the plain walks keep each ray's visit order, so they are
    the kernels' counts."""
    return {k: torch.zeros(n, dtype=torch.int64, device=device)
            for k in ("pops", "top_pops", "tests")}


def walk_tree(code, box, arity, tri_rec, base, root, tri_base, o, d, inv, inst_val,
              best, stats=None, carry=None):
    """The walk of one tree for ``n`` object-space rays ``o``/``d``/``inv``
    [n, 3], in the visit order that ``walk<A>`` of ``csrc/walk.cuh``
    keeps (children ranked near first, ties to the lower child, internal
    ones pushed farthest first, then the leaves tested nearest first):
    each ray walks the tree whose nodes
    are rows ``base + id`` of ``code [N, arity]`` / ``box``, from node id
    ``root``, with leaf starts relative to ``tri_base``, and ``inst_val``
    recorded on accepts. ``base``, ``root``, ``tri_base`` and
    ``inst_val`` are ints or [n] tensors. ``best`` = (t, tri, inst) [n]
    and the ``stats`` counters are updated in place, and so is ``carry``
    = (u, v, n) [n], [n], [n, 3] where given: the accepted triangle's
    barycentric u and v and its record's face normal (the kernels'
    ``Carry``), selected in the same accept as t."""
    t_b, tri_b, in_b = best
    n = d.shape[0]
    dev = d.device
    per_ray = lambda v: torch.as_tensor(v, device=dev).long().expand(n)
    base, tri_base, inst_val = per_ray(base), per_ray(tri_base), per_ray(inst_val)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int32, device=dev)
    stack[:, 0] = per_ray(root)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    lane = torch.arange(arity, device=dev)
    tie_mask = lane[None, :] < lane[:, None]  # [c, k]: k < c

    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            return
        spn = sp[idx] - 1
        node = stack[idx, spn].long() + base[idx]
        boxes = box[node][:, :6 * arity].reshape(-1, arity, 6)
        oi = o[idx][:, None, :]
        tb = t_b[idx]
        dist = child_entry(boxes, oi, inv[idx][:, None, :], tb[:, None])

        # near-first rank, ties by child index; order[p] = child of rank p
        dc = dist[:, :, None]
        dk = dist[:, None, :]
        rank = ((dk < dc) | ((dk == dc) & tie_mask)).sum(-1)
        order = torch.empty_like(rank).scatter_(1, rank, lane.expand(rank.shape[0], arity))
        count = (dist < BIG).sum(1)
        codes = code[node].gather(1, order).long()  # code of rank p

        # internal children pushed farthest first
        for p in range(arity - 1, -1, -1):
            c = codes[:, p]
            push = (count > p) & (c >= 0)
            stack[idx, spn] = torch.where(push, c, stack[idx, spn].long()).to(torch.int32)
            spn = spn + push.long()
        sp[idx] = spn

        # leaf children tested nearest first, ascending triangle index
        oi = oi[:, 0, :]
        di = d[idx]
        tri_i = tri_b[idx]
        in_i = in_b[idx]
        iv = inst_val[idx]
        start0 = tri_base[idx]
        if carry is not None:
            u_i, v_i, n_i = (x[idx] for x in carry)
        tested = torch.zeros_like(count)
        for p in range(arity):
            c = codes[:, p]
            packed = -c - 1
            cnt = torch.where((count > p) & (c < 0), packed & MAX_LEAF_TRIS,
                              torch.zeros_like(c))
            tested = tested + cnt
            width = int(cnt.max())
            if width == 0:
                continue
            j = torch.arange(width, device=dev)
            live = j[None, :] < cnt[:, None]
            k = torch.where(live, ((packed >> LEAF_BITS) + start0)[:, None] + j[None, :], 0)
            rec = tri_rec[k]
            t, ok, u, v = _test_tris(rec, oi[:, None, :], di[:, None, :])
            cand = torch.where(live & ok, t, torch.full_like(t, float("inf")))
            t_min, first = cand.min(dim=1)
            # strict t < t_best; at an exact-t tie the lower instance wins
            better = (t_min < tb) | ((t_min == tb) & (iv < in_i))
            tb = torch.where(better, t_min, tb)
            tri_i = torch.where(better, k.gather(1, first[:, None])[:, 0].to(torch.int32), tri_i)
            in_i = torch.where(better, iv.to(torch.int32), in_i)
            if carry is not None:
                pick = first[:, None]
                u_i = torch.where(better, u.gather(1, pick)[:, 0], u_i)
                v_i = torch.where(better, v.gather(1, pick)[:, 0], v_i)
                n_k = rec.gather(1, pick[:, :, None].expand(-1, 1, rec.shape[-1]))[:, 0, 3:6]
                n_i = torch.where(better[:, None], n_k, n_i)
        t_b[idx] = tb
        tri_b[idx] = tri_i
        in_b[idx] = in_i
        if carry is not None:
            carry[0][idx] = u_i
            carry[1][idx] = v_i
            carry[2][idx] = n_i
        if stats is not None:
            stats["pops"][idx] += 1
            stats["tests"][idx] += tested


def walk_instance(tables, q, root, inst_val, o, d, best, stats=None, carry=None):
    """Walk one instance's 4-wide tree for world rays ``o``/``d`` [n, 3],
    updating ``best`` = [t, tri, inst] (and ``stats`` and ``carry``) in
    place."""
    oo, od, inv = object_ray(q, o, d)
    walk_tree(tables.wcode, tables.wbox, 4, tables.tri_rec, 0, root, 0, oo, od, inv,
              inst_val, best, stats, carry)


def _test_tris(rec, o, d):
    """``make_test_tri`` without the ``t < t_best`` term: (t, ok, u, v)
    for records ``rec [..., 16]`` against rays ``o``/``d`` [..., 3]; u and
    v are the barycentrics a carrying accept selects."""
    denom = d[..., 0] * rec[..., 3] + d[..., 1] * rec[..., 4] + d[..., 2] * rec[..., 5]
    cx = rec[..., 0] - o[..., 0]
    cy = rec[..., 1] - o[..., 1]
    cz = rec[..., 2] - o[..., 2]
    num = cx * rec[..., 3] + cy * rec[..., 4] + cz * rec[..., 5]
    t = num / denom
    e2x = t * d[..., 0] - cx
    e2y = t * d[..., 1] - cy
    e2z = t * d[..., 2] - cz
    u = rec[..., 6] * e2x + rec[..., 7] * e2y + rec[..., 8] * e2z
    v = rec[..., 9] * e2x + rec[..., 10] * e2y + rec[..., 11] * e2z
    ok = ((denom <= -PARALLEL_EPS) & (u >= -EDGE_EPS) & (v >= -EDGE_EPS)
          & (u + v <= 1.0 + EDGE_EPS) & (t >= 0.0))
    return t, ok, u, v


def as_occlusion(hit):
    """The any-hit record of a nearest-hit record: t = -BIG where the
    ray hit something, FLT_MAX where it is clear."""
    blocked = hit.t < FLT_MAX
    t = torch.where(blocked, torch.full_like(hit.t, -BIG), torch.full_like(hit.t, FLT_MAX))
    return hit._replace(t=t)


def cast_rays_wide_torch(scene, origin, directions, occlusion: bool = False,
                         chunk: int = PLAIN_CHUNK, stats: bool = False,
                         carry_uv: bool = False, carry_n: bool = False, t_max: float = BIG):
    """Plain PyTorch version of K1: nearest hit nearer than ``t_max`` of
    every ray over the scene's 4-wide tables, for any number of instances
    (any hit with ``occlusion``), with the carried u and v (``carry_uv``)
    and face normal (``carry_n``) on the Hit where asked (K1's carrying
    kernel). With ``stats`` it returns ``(hit, counters)``, the per-ray
    counters of ``new_stats`` (of the nearest-hit walk, which the any-hit
    walk cuts short)."""
    tables = _wide_tables(scene)
    return cast_rays_tree_torch(scene, tables.wcode, tables.wbox, 4, tables.wroot, origin,
                                directions, occlusion, chunk, stats, carry_uv, carry_n, t_max)


def new_carry(r: int, device):
    """Zeroed carried fields (u, v, n) of ``r`` rays: a miss keeps them
    at 0, as the kernels' Carry starts."""
    return (torch.zeros(r, dtype=torch.float32, device=device),
            torch.zeros(r, dtype=torch.float32, device=device),
            torch.zeros(r, 3, dtype=torch.float32, device=device))


def check_carry(occlusion: bool, carry_uv: bool, carry_n: bool):
    """Raise for a carry in any-hit mode (``make_test_tri``'s rule: an
    occluded ray's fields mean nothing)."""
    if (carry_uv or carry_n) and occlusion:
        raise ValueError("carried attributes are meaningless for occlusion casts")


def carried(carry, carry_uv: bool, carry_n: bool):
    """The (u, v, n) of a Hit from the full carry: None for a field not
    carried."""
    if carry is None:
        return None
    u, v, n = carry
    return (u if carry_uv else None, v if carry_uv else None, n if carry_n else None)


def cast_rays_tree_torch(scene, code, box, arity: int, mesh_root, origin, directions,
                         occlusion: bool = False, chunk: int = PLAIN_CHUNK,
                         stats: bool = False, carry_uv: bool = False, carry_n: bool = False,
                         t_max: float = BIG):
    """K1's and K2's walk (``trace_ray<arity>`` of ``csrc/walk.cuh``) in
    ``walk_tree``'s visit order, vectorised over rays: each ray walks the
    tree of ``code``/``box`` (roots ``mesh_root [M]``) of every instance
    in index order, its best hit starting at ``t_max``. The plain version
    of K1 (4-wide tables, with the carry where asked) and K2 (binary
    tables)."""
    check_carry(occlusion, carry_uv, carry_n)
    origin, directions = _split_rays(origin, directions)
    shape = directions.shape[:-1]
    d_all = directions.reshape(-1, 3)
    o_all = origin.expand(directions.shape).reshape(-1, 3)
    inst_tab = instance_table(scene)
    roots = mesh_root[scene.inst_mesh.long()].tolist()
    num_inst = scene.num_instances
    dev = d_all.device
    r = d_all.shape[0]
    t = torch.full((r,), t_max, dtype=torch.float32, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    counters = new_stats(r, dev) if stats else None
    carry = new_carry(r, dev) if carry_uv or carry_n else None
    tri_rec = _wide_tables(scene).tri_rec
    for lo in range(0, r, chunk):
        sl = slice(lo, min(lo + chunk, r))
        best = (t[sl], tri[sl], inst[sl])  # views: updated in place
        part = None if counters is None else {k: v[sl] for k, v in counters.items()}
        cpart = None if carry is None else tuple(x[sl] for x in carry)
        for i in range(num_inst):
            oo, od, inv = object_ray(inst_tab[i], o_all[sl], d_all[sl])
            walk_tree(code, box, arity, tri_rec, 0, roots[i], 0, oo, od, inv,
                      i if num_inst > 1 else -1, best, part, cpart)
    return finish_plain(t, tri, inst, shape, num_inst, occlusion, counters,
                        carried(carry, carry_uv, carry_n))


def finish_plain(t, tri, inst, shape, num_instances: int, occlusion: bool = False,
                 counters=None, carry=None):
    """The plain walks' output record (``finish_hit`` of
    ``csrc/wide_traverse.cuh``: a ray that accepted no triangle is a miss,
    whatever bound its t started at) with the carried (u, v, n) of
    ``carried``, as an any-hit record with ``occlusion``, and with
    ``counters`` beside it when they were kept."""
    if num_instances == 1:
        inst = torch.where(tri >= 0, 0, -1).to(torch.int32)
    t = torch.where(tri < 0, torch.full_like(t, FLT_MAX), t)
    hit = _hit(t, tri, inst, shape, carry)
    hit = as_occlusion(hit) if occlusion else hit
    return hit if counters is None else (hit, counters)


def unexplained_differences(scene, origin, directions, a, b) -> int:
    """Rays where two nearest-hit casts of one scene disagree for a
    reason other than a visit order, for checking one traversal against
    another (K4-K6 against K1); 0 when every difference is explained.

    The triangle test accepts hits up to EDGE_EPS outside a triangle, so
    such a hit can lie outside its leaf's box, and a walk that tests that
    box against a t_best it already lowered culls it: which of two
    accepted hits a walk keeps then depends on the order it tests boxes
    in. A difference is explained when every hit either cast reports is
    accepted by the triangle test at the t it reports, and, where the two
    t differ, the nearer hit (the one the other cast lost) lies outside
    its leaf's padded box. A hit inside that box enters every box above
    it at or before its t, so no walk order can lose it."""
    diff = ((a.t.view(torch.int32) != b.t.view(torch.int32)) | (a.tri != b.tri)
            | (a.inst != b.inst)).reshape(-1)
    idx = torch.nonzero(diff).squeeze(1)
    if idx.numel() == 0:
        return 0
    d = directions.reshape(-1, 3)[idx]
    o = origin.expand(directions.shape).reshape(-1, 3)[idx]
    t_a, t_b = a.t.reshape(-1)[idx], b.t.reshape(-1)[idx]
    ok = torch.ones_like(t_a, dtype=torch.bool)
    inst_tab = instance_table(scene)
    leaves = torch.nonzero(scene.node_child_a < 0).squeeze(1)
    leaves = leaves[torch.argsort(scene.node_leaf_start[leaves], stable=True)]
    starts = scene.node_leaf_start[leaves].contiguous()
    for hit, t, lost in ((a, t_a, t_a < t_b), (b, t_b, t_b < t_a)):
        tri = hit.tri.reshape(-1)[idx]
        inst = hit.inst.reshape(-1)[idx].clamp(min=0)
        hits = tri >= 0
        for i in torch.unique(inst).tolist():
            sel = (inst == i) & hits
            oo, od, _ = object_ray(inst_tab[i], o[sel], d[sel])
            k = tri[sel].long()
            tt, acc, _, _ = _test_tris(scene.tri_rec[k], oo, od)
            leaf = leaves[torch.searchsorted(starts, tri[sel], right=True) - 1]
            p = oo + t[sel][:, None] * od
            outside = ((p < scene.node_min[leaf]) | (p > scene.node_max[leaf])).any(-1)
            ok[sel] &= acc & (tt == t[sel]) & (outside | ~lost[sel])
        ok &= hits | (t >= FLT_MAX)
    return int((~ok).sum())


# ---------------------------------------------------------------------------
# Kernel wrappers and router
# ---------------------------------------------------------------------------


def launch(entry: str, scene, origin, directions, occlusion: bool, tlas_args=(),
           arity: int | None = None, short_stack: int | None = None,
           carry_uv: bool = False, carry_n: bool = False, t_max: float = BIG,
           count: tuple = ()):
    """Check the inputs and launch ``entry`` of the kernel library on the
    current stream: ``wt_launch`` at ``arity`` 4 (K1, the 4-wide node
    records ``wnode``) or 2 (K2, the binary records of
    ``kernels/binary.py``), bounded by ``t_max``, or K3's ``tlas_launch``
    (no arity, no bound; ``wnode``), whose TLAS table pointers come in
    ``tlas_args``. Each takes ``short_stack`` ring slots per thread
    (default ``SHORT_STACK``) and a zeroed counter for its persistent
    warps. ``carry_uv``/``carry_n`` launch K1's or K3's carrying kernel
    (unbounded) with outputs for u, v and n. ``count`` names the launch
    counts it moves (``build.LAUNCHES``). Returns the Hit record; raises on
    a CUDA error at launch."""
    check_carry(occlusion, carry_uv, carry_n)
    if directions.device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda tensors, got {directions.device}")
    tables = _wide_tables(scene)
    node, mesh_root = tables.wnode, tables.wroot
    if arity == 2:
        from .binary import binary_tables

        tree = binary_tables(scene)
        node, mesh_root = tree.node, tree.root
    dev = directions.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    f32 = torch.float32
    build.check_inputs(dev, ("directions", directions, f32), ("origin", origin, f32),
                       ("node", node, f32), ("tri_rec", tables.tri_rec, f32),
                       aligned=("node", "tri_rec"))
    s = check_short_stack(short_stack)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    shape = directions.shape[:-1]
    r = directions.numel() // 3
    inst_tab = instance_table(scene)
    inst_root = mesh_root[scene.inst_mesh.long()].to(torch.int32).contiguous()
    t = torch.empty(r, dtype=f32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    inst = torch.empty(r, dtype=torch.int32, device=dev)
    # the kernel writes every ray's carried fields, 0 on a miss
    carry = tuple(torch.empty(size, dtype=f32, device=dev) if want else None
                  for want, size in ((carry_uv, (r,)), (carry_uv, (r,)), (carry_n, (r, 3))))
    head, bound = ((), ()) if arity is None else ((arity,), (t_max,))
    build.launch(
        entry, *head, node.data_ptr(), tables.tri_rec.data_ptr(), inst_tab.data_ptr(),
        inst_root.data_ptr(), scene.num_instances, *tlas_args,
        origin.data_ptr(), 0 if origin.dim() == 1 else 3, directions.data_ptr(), r,
        int(occlusion), t.data_ptr(), tri.data_ptr(), inst.data_ptr(),
        *(None if x is None else x.data_ptr() for x in carry), *bound, s,
        counter.data_ptr(), device=dev, count=count,
    )
    return _hit(t, tri, inst, shape, carry)


def check_short_stack(short_stack: int | None) -> int:
    """The ring slots of a launch's short stack (``SHORT_STACK`` if None),
    checked: a power of two in [1, 64]."""
    s = SHORT_STACK if short_stack is None else short_stack
    if not 1 <= s <= 64 or s & (s - 1):
        raise ValueError(f"short_stack must be a power of two in [1, 64], got {s}")
    return s


def launch_shape(kernel: str, occlusion: bool, num_rays: int,
                 short_stack: int | None = None, carry: bool = False) -> dict:
    """The launch K1, K2, K3, K4, K5 or K6 (``kernel``; K4-K6 have no
    any-hit mode; ``carry``: K1's or K3's carrying kernel) makes for
    ``num_rays`` rays: blocks of its grid
    (persistent, but for K6's one block per tile), threads per block,
    dynamic shared bytes (the short stack's ring) and resident blocks per
    SM."""
    import ctypes

    s = SHORT_STACK if short_stack is None else short_stack
    out = (ctypes.c_int * 4)()
    if carry and (occlusion or kernel not in ("K1", "K3")):
        raise ValueError(f"no carrying kernel for {kernel} occlusion={occlusion}")
    mode = 2 if carry else int(occlusion)  # the C side's 2: the carrying kernel
    if kernel in ("K1", "K2"):
        build.launch("wt_launch_shape", 4 if kernel == "K1" else 2, mode, s, num_rays, out)
    elif kernel == "K3":
        build.launch("tlas_launch_shape", mode, s, num_rays, out)
    elif kernel in ("K4", "K5") and not occlusion:
        build.launch("paged_launch_shape", 4 if kernel == "K4" else 2, s, num_rays, out)
    elif kernel == "K6" and not occlusion:
        build.launch("paged_major_launch_shape", s, num_rays, out)
    else:
        raise ValueError(f"no launch shape for {kernel} occlusion={occlusion}")
    return {"blocks": out[0], "threads": out[1], "shared_bytes": out[2],
            "blocks_per_sm": out[3]}


def cast_rays_cuda(scene, origin, directions, occlusion: bool = False,
                   short_stack: int | None = None, want_normals: bool = False,
                   carry: bool | None = None, t_max: float = BIG):
    """K1: nearest (or, with ``occlusion``, any) hit nearer than
    ``t_max`` over the 4-wide tables, with the carried fields
    ``carry_fields`` gives for ``want_normals`` and ``carry`` (K1's
    carrying kernel, which walks unbounded: a bounded cast carries
    nothing). CUDA tensors launch the kernel on the current stream, with
    ``short_stack`` ring slots per thread (default ``SHORT_STACK``); CPU
    tensors run the plain version."""
    origin, directions = _split_rays(origin, directions)
    bounded = t_max < BIG
    carry_uv, carry_n = carry_fields(scene, directions, occlusion, want_normals,
                                     False if bounded else carry)
    if directions.device.type == "cpu":
        return cast_rays_wide_torch(scene, origin, directions, occlusion, carry_uv=carry_uv,
                                    carry_n=carry_n, t_max=t_max)
    count = ("K1",) + ("K1_carry",) * (carry_uv or carry_n) + ("K1_bounded",) * bounded
    return launch("wt_launch", scene, origin, directions, occlusion, arity=4,
                  short_stack=short_stack, carry_uv=carry_uv, carry_n=carry_n, t_max=t_max,
                  count=count)


# The rows from which a scene is cast through page tables: the port's
# counterpart of the JAX router's VMEM_SCENE_BUDGET, whose budget is the
# TPU's VMEM. The rule is the leaf code's limit alone. ``python -m
# tpu_raytracer_torch.bench_paged sweep`` on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 6): cast ms, medians of 20 runs in turns,
# 1920x1088 primary / bounce rays. Below the limit no paged cast beat K1's
# by more than the runs' 10-90% spread: 22 columns (1,960,872 rows) K1
# 1.1318 / 1.6511 against K4 1.0937 / 1.7677, K5 1.0699 / 1.7109, K6
# 1.1622 / 6.3334 (spreads 0.06-0.27); 18 columns (1,316,744) K1 1.0913 /
# 1.3236 against 1.1155-1.1795 / 1.5035-4.0402. So no smaller scene is paged.
PAGING_ROWS = wide.LEAF_ROWS


def needs_paging(scene) -> bool:
    """Whether ``scene`` is cast through page tables: its triangle rows
    reach ``PAGING_ROWS``, the rows K1-K3's leaf codes address
    (``accel/wide.py LEAF_ROWS``, 2,097,152). On the card every table
    stays in device memory, so the leaf code is the one limit. A
    shape-only check."""
    return scene.num_triangles >= PAGING_ROWS


def cast_rays_paged_route(scene, origin, directions, occlusion: bool = False):
    """The cast of a scene that needs paging, on the ``cuda`` and ``bvh``
    backends (the JAX router's paged branch, ``traversal.py:1131``): K4
    through the scene's 4-wide page tables (K5 on binary ones), the
    kernel the sweep chose (``PAGING_ROWS``). The paged kernels have no
    any-hit mode, in either package, so an ``occlusion`` cast is the
    nearest-hit cast mapped through ``as_occlusion``; nothing is carried,
    so ``hit_attributes`` takes its redo. Raises for a scene without
    page tables: nothing builds them per cast."""
    # K4, as JAX routes (tpu_raytracer/kernels/paged.py:547), not K6: on
    # the sweep of PAGING_ROWS, K6's casts lose on bounce rays at every
    # size past the limit (26 columns, 2,752,280 rows: K6 1.1317 / 7.4346
    # ms primary / bounce against K4 1.0755 / 1.6171; 36 columns: 1.6194 /
    # 11.3146 against 1.4204 / 1.6658; 51 columns: 1.6937 / 24.7034
    # against 1.2436 / 1.6313).
    if scene.paged is None:
        raise ValueError(
            f"the scene needs paging ({scene.num_triangles} triangle rows reach "
            f"PAGING_ROWS, {PAGING_ROWS}) and has no page tables; attach them with "
            "scene.with_paging() (Scene.compile does with auto_page=True)")
    from .paged import cast_rays_paged_cuda

    hit = cast_rays_paged_cuda(scene, origin, directions)
    return as_occlusion(hit) if occlusion else hit


def cast_rays(scene, origin, directions, occlusion: bool = False, want_normals: bool = False,
              carry: bool | None = None, t_max: float = BIG):
    """The cast of the ``cuda`` backend (counterpart of
    ``cast_rays_pallas``): a scene that needs paging through its page
    tables (``cast_rays_paged_route``), then K3 for scenes with two or
    more instances and a TLAS, K1 otherwise. ``want_normals`` and
    ``carry`` choose the carried fields of K1 and K3
    (``carry_fields``). K1 walks bounded by ``t_max``; K3 and K4 ignore
    it, so a hit nearer than ``t_max`` is reported on every route and one
    beyond it may be."""
    if needs_paging(scene):
        return cast_rays_paged_route(scene, origin, directions, occlusion)
    _wide_tables(scene)
    if scene.num_instances >= 2 and scene.tlas is not None:
        from .tlas import cast_rays_tlas_cuda

        return cast_rays_tlas_cuda(scene, origin, directions, occlusion,
                                   want_normals=want_normals, carry=carry)
    return cast_rays_cuda(scene, origin, directions, occlusion, want_normals=want_normals,
                          carry=carry, t_max=t_max)
