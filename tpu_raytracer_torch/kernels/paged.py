"""Paged casts for big scenes: the page tables, kernels K4 (4-wide pages)
and K5 (binary pages), and their plain PyTorch version.

Counterpart of ``tpu_raytracer/kernels/paged.py`` (``prepare_paged``,
``_build_page_wide``, ``cast_rays_paged``) and
``kernels/paged_wide.py``. The scene's BVH is cut into pages
(``accel/paging.py``) under a small binary top tree whose leaves are
portals to pages. The JAX kernels stream one page at a time from HBM
into VMEM; on the card every table stays in device memory, so the port
keeps the same tables in a flat layout for one thread per ray:

  * the top tree: ``top_code [Nt] i32`` (internal -> rank of child b,
    child a = rank + 1; portal -> -(page + 1)), ``top_box [Nt, 12]``
    (child a's and child b's boxes, NUDGE baked in), ``top_root [M]``;
  * per page: ``page_node0`` (global node id of its root, whose box the
    page-major plan reads), ``page_tri0`` (its first triangle) and
    ``node_base`` (the row of its root in ``code``/``box``);
  * the pages' trees, concatenated, in the child-code layout of
    ``accel/wide.py`` with page-local node ids (root 0) and leaf starts
    relative to ``page_tri0``: 4-wide (``collapse4``, ``arity`` 4: K4
    and K6) or binary (``collapse2``, ``arity`` 2: K5);
  * ``node [N, 8 * arity]``, the same trees' node records
    (``wide4.node_records``: the box floats, the codes bit-cast into
    lanes 24..27 at arity 4 or 12..13 at arity 2, zeros after them),
    which K4, K5 and K6 read as 16-byte loads (``csrc/walk.cuh``);
    ``code``/``box`` stay for the plain version.

The JAX package's 128-lane rows, fixed per-page row strides and 8-row
DMA padding are layout for VMEM and are dropped; ``paged_from_jax``
unpacks JAX tables into this layout, so both packages can run on the
same pages.

  * ``cast_rays_paged_cuda`` is the wrapper of K4 and K5: for CUDA
    tensors it launches the hand-written kernel
    (``csrc/paged_traverse.cu``, arity from the tables: K4's
    ``paged_wide_kernel`` or K5's ``paged_binary_kernel``, both on the
    walk of ``csrc/walk.cuh``) and counts the launch in ``build.LAUNCHES``
    (``K4`` or ``K5``); for CPU tensors it runs the plain version. A CUDA
    tensor never reaches the plain version and a failed build or launch
    raises.
  * ``cast_rays_paged_torch`` is the plain version: the same per-ray
    walk (top tree, then each reached page with ``traversal.walk_tree``)
    vectorised over rays, in the kernel's visit order, so the two agree
    bit for bit.

The nearest ``t`` equals K1's on the same scene bit for bit but where a
hit accepted up to EDGE_EPS outside its leaf box is kept or culled by
box order; ``tri`` and ``inst`` may differ from K1's only there or at
exact-``t`` ties (``csrc/paged_traverse.cuh``,
``traversal.unexplained_differences``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.paging import PAGE_NODES, PAGE_TRIS, _subtree_extents, build_page_table
from ..accel.wide import LEAF_ROWS, collapse2, collapse4
from .build import check_inputs, launch
from .tlas import _depth
from .traversal import (
    PLAIN_CHUNK,
    BIG,
    _hit,
    _split_rays,
    box_stride,
    check_short_stack,
    child_entry,
    finish_plain,
    instance_table,
    new_stats,
    object_ray,
    walk_tree,
)
from .wide4 import NUDGE, STACK_SIZE, node_records, stack_needed

TOP_STACK = 64  # the plain version's per-ray top-tree stack
# In-page leaf starts are page-local, so a page may hold as many triangles
# as a leaf code can address.
MAX_PAGE_TRIS = LEAF_ROWS


@dataclasses.dataclass(frozen=True)
class PagedTables:
    """The page partition of one compiled scene and its page trees."""

    arity: int  # 4: per-page 4-wide trees (K4, K6); 2: binary trees (K5)
    top_code: torch.Tensor  # [Nt] i32
    top_box: torch.Tensor  # [Nt, 12] f32
    top_root: torch.Tensor  # [M] i32 top-tree rank of each mesh root
    page_node0: torch.Tensor  # [P] i32 global node id of each page root
    page_tri0: torch.Tensor  # [P] i32 first triangle of each page
    node_base: torch.Tensor  # [P] i32 row of each page's root in code/box
    code: torch.Tensor  # [N, arity] i32 page-local child codes
    box: torch.Tensor  # [N, box_stride(arity)] f32 child boxes, NUDGE baked in
    node: torch.Tensor  # [N, 8 * arity] f32 node records (K4-K6)
    top_depth: int  # nodes on the longest top-tree path
    depth: int  # nodes on the longest path of any page tree
    # the capacities the pages were cut with (None: unknown, for tables
    # unpacked from the JAX package's by paged_from_jax)
    page_tris: int | None = None
    page_nodes: int | None = None

    @property
    def num_pages(self) -> int:
        return self.page_node0.shape[0]

    def to(self, device) -> "PagedTables":
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _records(w, arity: int) -> tuple[np.ndarray, np.ndarray]:
    """(code [W, arity] i32, box [W, box_stride] f32) of a collapsed
    tree, boxes widened by NUDGE as K1's tables are."""
    n = w.num_nodes
    box = np.zeros((n, box_stride(arity)), np.float32)
    for c in range(arity):
        box[:, 6 * c:6 * c + 3] = w.wbox_min[:, c] - np.float32(NUDGE)
        box[:, 6 * c + 3:6 * c + 6] = w.wbox_max[:, c] + np.float32(NUDGE)
    return w.wcode.reshape(n, arity), box


def _page_trees(pt, child_a, child_b, leaf_start, leaf_count, node_min, node_max,
                arity: int):
    """Every page's subtree collapsed to ``arity`` with page-local node
    ids and leaf starts (``paged.py:_build_page_wide`` of the JAX
    package, at arity 4); returns (code, box, node_base) as numpy."""
    collapse = collapse4 if arity == 4 else collapse2
    size, _, _ = _subtree_extents(child_a, child_b, leaf_start, leaf_count)
    is_leaf = child_a < 0
    codes, boxes, base = [], [], []
    rows = 0
    for n0, t0 in zip(pt.page_node0.tolist(), pt.page_tri0.tolist()):
        sl = slice(n0, n0 + int(size[n0]))
        lf = is_leaf[sl]
        w = collapse(
            np.where(lf, child_a[sl], child_a[sl] - n0),
            np.where(lf, child_b[sl], child_b[sl] - n0),
            np.where(lf, leaf_start[sl] - t0, 0),
            leaf_count[sl], node_min[sl], node_max[sl], np.zeros(1, np.int64),
        )
        code, box = _records(w, arity)
        codes.append(code)
        boxes.append(box)
        base.append(rows)
        rows += len(code)
    return np.concatenate(codes), np.concatenate(boxes), np.asarray(base, np.int32)


def _tables(top_code, top_box, top_root, page_node0, page_tri0, node_base, code, box,
            arity: int, device, page_tris: int | None = None,
            page_nodes: int | None = None) -> PagedTables:
    depth = _page_depth(code, node_base)
    if stack_needed(depth, arity) > STACK_SIZE:
        raise ValueError(f"page tree depth {depth} overflows the {STACK_SIZE}-slot stack")
    top_depth = _depth(top_code)
    if top_depth >= TOP_STACK:
        raise ValueError(f"top tree depth {top_depth} overflows the {TOP_STACK}-slot stack")
    t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(device)  # a writable copy
    return PagedTables(
        arity=arity, top_code=t(top_code, np.int32), top_box=t(top_box, np.float32),
        top_root=t(top_root, np.int32), page_node0=t(page_node0, np.int32),
        page_tri0=t(page_tri0, np.int32), node_base=t(node_base, np.int32),
        code=t(code, np.int32), box=t(box, np.float32),
        node=t(node_records(code, box), np.float32), top_depth=top_depth, depth=depth,
        page_tris=page_tris, page_nodes=page_nodes,
    )


def _page_depth(code: np.ndarray, node_base: np.ndarray) -> int:
    """Deepest page tree: ids in ``code`` are page-local, so walk each
    page's level sets from its root with its base added."""
    bounds = np.append(node_base, len(code))
    page_of = np.repeat(np.arange(len(node_base)), np.diff(bounds))
    depth, level = 0, np.asarray(node_base, np.int64)
    while level.size:
        depth += 1
        c = code[level]
        base = node_base[page_of[level]][:, None]
        level = (c + base)[c >= 0]
    return depth


def prepare_paged(scene, page_tris: int = PAGE_TRIS, page_nodes: int = PAGE_NODES,
                  wide: bool = True) -> PagedTables:
    """Cut the compiled scene's BVH into pages of at most ``page_tris``
    triangles and ``page_nodes`` binary nodes and build the page trees:
    4-wide with ``wide`` (K4 and K6), binary without (K5). Host work,
    once per scene; the tables land on the scene's device."""
    if not 8 <= page_tris <= MAX_PAGE_TRIS:
        raise ValueError(f"page_tris must be in [8, {MAX_PAGE_TRIS}] (the leaf code's "
                         f"start field), got {page_tris}")
    if page_nodes < 1:
        raise ValueError(f"page_nodes must be positive, got {page_nodes}")
    f = lambda name: getattr(scene, name).cpu().numpy()
    child_a, child_b = f("node_child_a"), f("node_child_b")
    leaf_start, leaf_count = f("node_leaf_start"), f("node_leaf_count")
    node_min, node_max = f("node_min"), f("node_max")
    pt = build_page_table(node_min, node_max, child_a, child_b, leaf_start, leaf_count,
                          f("mesh_root"), page_tris=page_tris, page_nodes=page_nodes)
    nudge = np.float32(NUDGE)
    top_box = np.concatenate(
        [pt.top_child_min[:, 0] - nudge, pt.top_child_max[:, 0] + nudge,
         pt.top_child_min[:, 1] - nudge, pt.top_child_max[:, 1] + nudge], axis=1)
    arity = 4 if wide else 2
    code, box, node_base = _page_trees(pt, child_a, child_b, leaf_start, leaf_count,
                                       node_min, node_max, arity)
    return _tables(pt.top_code, top_box, pt.top_root, pt.page_node0, pt.page_tri0,
                   node_base, code, box, arity, scene.device, page_tris, page_nodes)


def paged_from_jax(tables, device="cuda", wide: bool = True) -> PagedTables:
    """The port's tables from the JAX package's ``PagedTables`` given as
    a dict of numpy arrays keyed by its field names: the top tree and
    page table unpacked from their 128-lane rows, and the page trees
    from the per-page 4-wide windows (``wide``) or from the global binary
    code and node records."""
    top_code = np.asarray(tables["top_code"]).reshape(-1)
    top_nodef = np.asarray(tables["top_nodef"]).reshape(-1, 16)
    nt = _top_size(top_code, np.asarray(tables["top_root"]))
    top_code, top_box = top_code[:nt], top_nodef[:nt, :12]
    page_tab = np.asarray(tables["page_tab"])
    node0, tri0 = page_tab[:, 0], page_tab[:, 1]
    if wide:
        pwcode = np.asarray(tables["pwcode"]).reshape(len(node0), -1)
        pwnode = np.asarray(tables["pwnodef"]).reshape(len(node0), -1, 32)
        codes, boxes = [], []
        for p in range(len(node0)):
            c = pwcode[p]
            n = int(c.max(initial=0)) + 1  # wide ids 0..n-1 are all reached
            codes.append(c[:4 * n].reshape(n, 4))
            boxes.append(pwnode[p, :n])
    else:
        codes, boxes = _binary_pages_from_jax(tables, node0, top_code, top_box)
    node_base = np.cumsum([0] + [len(c) for c in codes[:-1]]).astype(np.int32)
    return _tables(top_code, top_box, np.asarray(tables["top_root"]), node0, tri0,
                   node_base, np.concatenate(codes), np.concatenate(boxes), 4 if wide else 2,
                   device)


def _top_size(top_code: np.ndarray, top_root: np.ndarray) -> int:
    """Top-tree nodes in a -1-padded code row: one past the last node
    reached from the mesh roots (child a = node + 1, child b = code)."""
    last = 0
    stack = [int(r) for r in top_root]
    while stack:
        node = stack.pop()
        last = max(last, node)
        if top_code[node] >= 0:
            stack += [int(top_code[node]), node + 1]
    return last + 1


def _binary_pages_from_jax(tables, node0, top_code, top_box):
    """Per-page arity-2 trees from the JAX global binary code (leaf
    starts already page-local) and node records. A page that is a whole
    single-leaf mesh has its box nowhere in the JAX tables (the JAX
    kernel tests that leaf without one); it gets an unbounded box."""
    gcode = np.asarray(tables["gcode"]).reshape(-1)
    gbox = np.asarray(tables["gnodef"]).reshape(-1, 16)[:, :12]
    # the box of a single-leaf page sits in its portal's parent record
    parent_box = {}
    for t in np.nonzero(top_code >= 0)[0]:
        parent_box[int(t) + 1] = top_box[t, 0:6]
        parent_box[int(top_code[t])] = top_box[t, 6:12]
    portal_of = {int(-c - 1): t for t, c in enumerate(top_code) if c < 0}
    codes, boxes = [], []
    for p, n0 in enumerate(node0.tolist()):
        if gcode[n0] < 0:
            big = np.float32(3.0e38)
            box = np.zeros((1, 12), np.float32)
            box[0, :6] = parent_box.get(portal_of[p], (-big, -big, -big, big, big, big))
            box[0, 6:9], box[0, 9:12] = big, -big
            codes.append(np.array([[gcode[n0], -1]], np.int32))
            boxes.append(box)
            continue
        end = n0
        while gcode[end] >= 0:  # the rightmost leaf ends the subtree
            end = int(gcode[end])
        ids = np.arange(n0, end + 1)
        inner = ids[gcode[ids] >= 0]
        local = np.full(end + 1 - n0, -1, np.int64)
        local[inner - n0] = np.arange(len(inner))
        kids = np.stack([inner + 1, gcode[inner]], axis=1)
        code = np.where(gcode[kids] >= 0, local[kids - n0], gcode[kids])
        codes.append(code.astype(np.int32))
        boxes.append(gbox[inner])
    return codes, boxes


def _paged_tables(scene) -> PagedTables:
    if scene.paged is None:
        raise ValueError("scene has no page tables: call scene.with_paging() first")
    return scene.paged


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _walk_paged(pg, tri_rec, q, top_root, inst_val, o, d, best, stats=None):
    """Walk one instance for world rays ``o``/``d`` [n, 3]: each round
    pops every live ray's top-tree stack down to its next portal (the
    nearer child pushed last, child a on a tie), then walks the reached
    pages, each ray its own, with ``walk_tree``. Updates ``best`` and
    ``stats`` in place."""
    t_b, tri_b, in_b = best
    oo, od, inv = object_ray(q, o, d)
    n = d.shape[0]
    dev = d.device
    code_t = pg.top_code.long()
    stack = torch.zeros((n, TOP_STACK), dtype=torch.int64, device=dev)
    stack[:, 0] = top_root
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    while True:
        portal = torch.full((n,), -1, dtype=torch.int64, device=dev)
        while True:
            idx = torch.nonzero((sp > 0) & (portal < 0)).squeeze(1)
            if idx.numel() == 0:
                break
            spn = sp[idx] - 1
            node = stack[idx, spn]
            code = code_t[node]
            internal = code >= 0
            portal[idx] = torch.where(internal, -1, -code - 1)
            dist = child_entry(pg.top_box[node].reshape(-1, 2, 6), oo[idx][:, None, :],
                               inv[idx][:, None, :], t_b[idx][:, None])
            da, db = dist[:, 0], dist[:, 1]
            a_near = da <= db
            ca = node + 1
            for child, pushed in (
                (torch.where(a_near, code, ca), torch.where(a_near, db, da) < BIG),
                (torch.where(a_near, ca, code), torch.where(a_near, da, db) < BIG),
            ):
                push = internal & pushed
                stack[idx, spn] = torch.where(push, child, stack[idx, spn])
                spn = spn + push.long()
            sp[idx] = spn
            if stats is not None:
                stats["top_pops"][idx] += internal.long()
        rays = torch.nonzero(portal >= 0).squeeze(1)
        if rays.numel() == 0:
            return
        pid = portal[rays]
        part = (t_b[rays], tri_b[rays], in_b[rays])
        sub = None if stats is None else {k: v[rays] for k, v in stats.items()}
        walk_tree(pg.code, pg.box, pg.arity, tri_rec, pg.node_base[pid], 0, pg.page_tri0[pid],
                  oo[rays], od[rays], inv[rays], inst_val, part, sub)
        t_b[rays], tri_b[rays], in_b[rays] = part
        if stats is not None:
            for k, v in sub.items():
                stats[k][rays] = v


def cast_rays_paged_torch(scene, origin, directions, chunk: int = PLAIN_CHUNK,
                          stats: bool = False):
    """Plain PyTorch version of K4 (4-wide page tables) and K5 (binary):
    nearest hit of every ray through the scene's page tables. With
    ``stats`` it returns ``(hit, counters)`` (``traversal.new_stats``)."""
    origin, directions = _split_rays(origin, directions)
    pg = _paged_tables(scene)
    tri_rec = scene.tri_rec
    shape = directions.shape[:-1]
    d_all = directions.reshape(-1, 3)
    o_all = origin.expand(directions.shape).reshape(-1, 3)
    inst_tab = instance_table(scene)
    roots = pg.top_root[scene.inst_mesh.long()].tolist()
    num_inst = scene.num_instances
    dev = d_all.device
    r = d_all.shape[0]
    t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    counters = new_stats(r, dev) if stats else None
    for lo in range(0, r, chunk):
        sl = slice(lo, min(lo + chunk, r))
        part = None if counters is None else {k: v[sl] for k, v in counters.items()}
        for i in range(num_inst):
            _walk_paged(pg, tri_rec, inst_tab[i], roots[i], i if num_inst > 1 else -1,
                        o_all[sl], d_all[sl], (t[sl], tri[sl], inst[sl]), part)
    return finish_plain(t, tri, inst, shape, num_inst, counters=counters)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def page_args(scene, directions) -> tuple:
    """The page-tree arguments of ``paged_launch`` and
    ``paged_major_launch`` (arity through num_instances), checked: the
    tables must be contiguous, of the kernel's types, on the rays'
    device, and the tables read with 16-byte loads 16-byte aligned. Also
    returns the instance table, which the caller keeps alive until the
    launch."""
    pg = _paged_tables(scene)
    tri_rec = scene.tri_rec
    inst_tab = instance_table(scene)
    check_inputs(directions.device, ("directions", directions, torch.float32),
                 ("node", pg.node, torch.float32), ("node_base", pg.node_base, torch.int32),
                 ("page_tri0", pg.page_tri0, torch.int32), ("tri_rec", tri_rec, torch.float32),
                 ("top_code", pg.top_code, torch.int32), ("top_box", pg.top_box, torch.float32),
                 aligned=("node", "tri_rec", "top_box"))
    return (pg.arity, pg.node.data_ptr(), pg.node_base.data_ptr(), pg.page_tri0.data_ptr(),
            tri_rec.data_ptr(), inst_tab.data_ptr(), scene.num_instances), inst_tab


def ray_args(origin, directions, outputs) -> tuple:
    """(origin, origin_stride, dirs, num_rays, t, tri, inst) of a launch,
    the origin checked."""
    check_inputs(directions.device, ("origin", origin, torch.float32))
    r = directions.numel() // 3
    return (origin.data_ptr(), 0 if origin.dim() == 1 else 3, directions.data_ptr(), r,
            *(x.data_ptr() for x in outputs))


def cast_rays_paged_cuda(scene, origin, directions, short_stack: int | None = None):
    """K4 (4-wide page tables) or K5 (binary): nearest hit through the
    scene's page tables. CUDA tensors launch the kernel on the current
    stream with ``short_stack`` ring slots per thread (default
    ``wide4.SHORT_STACK``); CPU tensors run the plain version."""
    origin, directions = _split_rays(origin, directions)
    if directions.device.type == "cpu":
        return cast_rays_paged_torch(scene, origin, directions)
    if scene.device != directions.device:
        raise ValueError(f"scene on {scene.device}, rays on {directions.device}")
    pages, keep_alive = page_args(scene, directions)
    pg = scene.paged
    s = check_short_stack(short_stack)
    # the top tree's entries (at most one per level) sit below a page walk's
    need = pg.top_depth + stack_needed(pg.depth, pg.arity)
    if need > STACK_SIZE:
        raise ValueError(f"top tree depth {pg.top_depth} with the pages' stack needs "
                         f"{need} stack slots; the kernel has {STACK_SIZE}")
    counter = torch.zeros(1, dtype=torch.int64, device=directions.device)
    top_root = pg.top_root[scene.inst_mesh.long()].to(torch.int32).contiguous()
    r = directions.numel() // 3
    out = (torch.empty(r, dtype=torch.float32, device=directions.device),
           torch.empty(r, dtype=torch.int32, device=directions.device),
           torch.empty(r, dtype=torch.int32, device=directions.device))
    launch("paged_launch", *pages, pg.top_code.data_ptr(), pg.top_box.data_ptr(),
           top_root.data_ptr(), *ray_args(origin, directions, out), s, counter.data_ptr(),
           device=directions.device, count=("K4" if pg.arity == 4 else "K5",))
    return _hit(*out, directions.shape[:-1])
