"""Page-major paged casts: the plan, kernel K6, and their plain PyTorch
versions.

Counterpart of ``tpu_raytracer/kernels/paged_major.py``. The JAX kernel
inverts the paged loop for the TPU: all rays' state stays in VMEM while
(instance, page) ITEMS stream through front to back, each page DMA'd
once per frame, with a conservative per-tile visibility mask so a tile
skips the items it cannot see. On the card there is no VMEM budget to
stream under, so K6 keeps the plan and the order and drops the staging
(and the JAX package's 80 MB state budget and chunking):

  * ``page_major_plan`` is the plain version of the plan, that of
    ``_tile_bounds`` and ``_item_plan``: for each tile of ``TILE_RAYS``
    rays, interval bounds of its object-space origins and reciprocal
    directions per instance; an interval slab test of each page's root
    box (out-rounded) against them; items sorted front to back by the
    nearest entry of any tile that may see them (stable, so equal keys
    keep instance-major, page-minor order); items no tile sees dropped.
    ``tile_lists`` turns its mask into each tile's list of items.
  * ``page_major_plan_cuda`` is the plan's wrapper: for CUDA tensors it
    launches the hand-written plan kernels (``csrc/page_plan.cu``),
    which give the same item order and lists with no host sync, and
    counts the launch in ``build.LAUNCHES`` (``K6_plan``); for CPU tensors
    it runs the plain version.
  * ``cast_rays_paged_major_cuda`` is K6's wrapper: for CUDA tensors it
    makes the plan on the card and launches the hand-written kernel
    (``csrc/paged_major.cu``: each thread walks its tile's items in plan
    order with the walk of ``csrc/walk.cuh``, its best hit in
    registers), counting the launch in ``build.LAUNCHES`` (``K6``), and
    the whole cast
    waits on the host for nothing; for CPU tensors it runs the plain
    version. An image's rays go in 16x16-pixel tiles, other ray sets in
    runs of ``TILE_RAYS``.
  * ``cast_rays_paged_major_torch`` is the plain version: the same walk
    vectorised over rays (round j walks every ray's j-th visible item),
    in the kernel's per-ray order, so the two agree bit for bit.

The nearest ``t`` equals K1's bit for bit; ``tri``/``inst`` may differ
from K1's, K4's or the brute cast's only where two triangles in
different pages tie on ``t`` exactly (``paged_major.py:51-59`` of the
JAX package).
"""

from __future__ import annotations

import torch

from .build import check_inputs, launch
from .paged import _paged_tables, page_args, ray_args
from .traversal import (
    BIG,
    PLAIN_CHUNK,
    _hit,
    _split_rays,
    check_short_stack,
    finish_plain,
    instance_table,
    new_stats,
    object_ray,
    walk_tree,
)

TILE_RAYS = 256  # rays per tile and per block (csrc/paged_traverse.cuh kTileRays)
TILE_PIX = 16  # an image tile is TILE_PIX x TILE_PIX pixels
# Interval widening of the tile bounds (the JAX package's frustum
# margins, traversal.py:_FRUSTUM_REL/_ABS): only adds visits.
FRUSTUM_REL = 4e-6
FRUSTUM_ABS = 1e-12


def tile_order(shape, device) -> torch.Tensor | None:
    """Permutation of the flat rays of an image ``shape`` (H, W) that
    puts each 16x16-pixel tile's rays together, tiles in row-major
    order; None (keep the flat order) for any other shape."""
    if len(shape) != 2 or shape[0] % TILE_PIX or shape[1] % TILE_PIX:
        return None
    h, w = shape
    idx = torch.arange(h * w, device=device).reshape(h // TILE_PIX, TILE_PIX,
                                                     w // TILE_PIX, TILE_PIX)
    return idx.permute(0, 2, 1, 3).reshape(-1)


def _widen(lo, hi):
    return (lo - (lo.abs() * FRUSTUM_REL + FRUSTUM_ABS),
            hi + (hi.abs() * FRUSTUM_REL + FRUSTUM_ABS))


def page_major_plan(scene, origin, directions):
    """The plan for rays in tile order (``origin`` [3] or [R, 3],
    ``directions`` [R, 3]): (item_pid [K] i32, item_iid [K] i32, mask
    [K, n_tiles] u8), items front to back, every item seen by some tile."""
    pg = _paged_tables(scene)
    dev = directions.device
    r = directions.shape[0]
    n_tiles = -(-r // TILE_RAYS)
    pad = n_tiles * TILE_RAYS - r
    tiled = lambda x: torch.cat([x, x[-1:].expand(pad, 3)]).reshape(n_tiles, TILE_RAYS, 3)
    d = tiled(directions)
    o = origin.expand(r, 3) if origin.dim() == 1 else origin
    o = tiled(o)
    node0 = pg.page_node0.long()
    bmin = scene.node_min[node0]  # [P, 3]
    bmax = scene.node_max[node0]
    # out-round: in-page slab tests use NUDGE-widened child boxes
    padding = (bmax - bmin) * 1e-6 + 1e-9
    bmin, bmax = bmin - padding, bmax + padding
    page_mesh = torch.searchsorted(scene.mesh_root.long(), node0, right=True) - 1
    inst_tab = instance_table(scene)
    wanted, near = [], []
    for i in range(scene.num_instances):
        oo, _, inv = object_ray(inst_tab[i], o, d)
        oo_lo, oo_hi = _widen(oo.amin(1)[:, None], oo.amax(1)[:, None])  # [n, 1, 3]
        inv_lo, inv_hi = _widen(inv.amin(1)[:, None], inv.amax(1)[:, None])

        def products(n_lo, n_hi):
            p = torch.stack([n_lo * inv_lo, n_lo * inv_hi, n_hi * inv_lo, n_hi * inv_hi])
            return p.amin(0), p.amax(0)

        t1_lo, t1_hi = products(bmin[None] - oo_hi, bmin[None] - oo_lo)  # [n, P, 3]
        t2_lo, t2_hi = products(bmax[None] - oo_hi, bmax[None] - oo_lo)
        near_lo = torch.minimum(t1_lo, t2_lo).amax(-1)  # [n, P]
        far_hi = torch.maximum(t1_hi, t2_hi).amin(-1)
        owned = (page_mesh == scene.inst_mesh[i].long())[None]
        wanted.append((far_hi >= near_lo) & (far_hi > 0.0) & owned)
        near.append(near_lo)
    wanted = torch.cat(wanted, dim=1)  # [n_tiles, I*P], instance-major
    near = torch.cat(near, dim=1)
    key = torch.where(wanted, near, torch.full_like(near, float("inf"))).amin(0)
    seen = wanted.any(0)
    order = torch.argsort(torch.where(seen, key, torch.full_like(key, float("inf"))),
                          stable=True)
    order = order[: int(seen.sum())]
    p = pg.num_pages
    item_pid = (order % p).to(torch.int32).contiguous()
    item_iid = (order // p).to(torch.int32).contiguous()
    mask = wanted[:, order].T.to(torch.uint8).contiguous()
    return item_pid, item_iid, mask


def tile_lists(mask):
    """Each tile's items in plan order from a plan's ``mask [K, n_tiles]``:
    (tile_start [n_tiles + 1] i32, tile_item [nnz] i32), tile t's items
    being ``tile_item[tile_start[t]:tile_start[t + 1]]``, ascending."""
    seen = torch.nonzero(mask.T)  # (tile, item), tile-major, items ascending
    count = mask.sum(0, dtype=torch.int32)
    start = torch.zeros(mask.shape[1] + 1, dtype=torch.int32, device=mask.device)
    start[1:] = torch.cumsum(count, 0)
    return start, seen[:, 1].to(torch.int32).contiguous()


def plan_args(scene, origin, directions, inst_tab=None) -> tuple:
    """The arguments of ``page_plan_launch`` (and of the host build's
    ``page_plan_host``, which takes the same but the stream) for rays in
    tile order, checked, with its scratch and outputs allocated on the
    rays' device: (args, (item_pid, item_iid, tile_start, tile_item),
    tensors to keep alive until the launch). ``inst_tab`` is the scene's
    ``instance_table`` where the caller has it. ``tile_item`` has room for
    every tile to see every item; the plan fills ``tile_start[-1]``
    entries."""
    pg = _paged_tables(scene)
    dev = directions.device
    r = directions.shape[0]
    n_tiles = -(-r // TILE_RAYS)
    k = scene.num_instances * pg.num_pages
    inst_tab = instance_table(scene) if inst_tab is None else inst_tab
    node0 = pg.page_node0
    f32, int32 = torch.float32, torch.int32
    check_inputs(dev, ("origin", origin, f32), ("directions", directions, f32),
                 ("node_min", scene.node_min, f32), ("node_max", scene.node_max, f32),
                 ("page_node0", node0, int32), ("mesh_root", scene.mesh_root, int32),
                 ("inst_mesh", scene.inst_mesh, int32), ("inst_tab", inst_tab, f32))
    i32 = lambda n: torch.empty(n, dtype=torch.int32, device=dev)
    wanted = torch.empty(n_tiles * k, dtype=torch.uint8, device=dev)
    tile_count, key = i32(n_tiles), torch.empty(k, dtype=torch.float32, device=dev)
    plan = (i32(k), i32(k), i32(n_tiles + 1), i32(max(n_tiles * k, 1)))
    args = (origin.data_ptr(), 0 if origin.dim() == 1 else 3, directions.data_ptr(), r,
            inst_tab.data_ptr(), scene.inst_mesh.data_ptr(), scene.num_instances,
            scene.node_min.data_ptr(), scene.node_max.data_ptr(), node0.data_ptr(),
            pg.num_pages, scene.mesh_root.data_ptr(), scene.mesh_root.shape[0],
            wanted.data_ptr(), tile_count.data_ptr(), key.data_ptr(),
            *(x.data_ptr() for x in plan))
    return args, plan, (inst_tab, wanted, tile_count, key)


def page_major_plan_cuda(scene, origin, directions, inst_tab=None):
    """K6's plan for rays in tile order (``origin`` [3] or [R, 3],
    ``directions`` [R, 3]): (item_pid, item_iid, tile_start, tile_item).
    CUDA tensors launch the plan kernels on the current stream: every
    item is ordered, those no tile sees last, and ``tile_item`` is
    allocated for every tile seeing every item; nothing waits on the
    host. CPU tensors run the plain version (``page_major_plan`` and
    ``tile_lists``), whose items are the seen ones only. ``inst_tab`` is
    the scene's ``instance_table`` where the caller has it."""
    if directions.device.type == "cpu":
        item_pid, item_iid, mask = page_major_plan(scene, origin, directions)
        return (item_pid, item_iid, *tile_lists(mask))
    args, plan, keep_alive = plan_args(scene, origin, directions, inst_tab)
    launch("page_plan_launch", *args, device=directions.device, count=("K6_plan",))
    return plan


def _tile_rays(origin, directions):
    """(permutation or None, origin, directions) with the rays in tile
    order, contiguous."""
    perm = tile_order(directions.shape[:-1], directions.device)
    d = directions.reshape(-1, 3)
    o = origin if origin.dim() == 1 else origin.reshape(-1, 3)
    if perm is not None:
        d = d.index_select(0, perm)
        o = o if o.dim() == 1 else o.index_select(0, perm)
    return perm, o.contiguous(), d.contiguous()


def _untile(perm, x):
    if perm is None:
        return x
    return torch.empty_like(x).index_copy_(0, perm, x)


def _require_wide(scene):
    if _paged_tables(scene).arity != 4:
        raise ValueError("the page-major cast needs 4-wide page tables "
                         "(scene.with_paging(wide=True))")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def cast_rays_paged_major_torch(scene, origin, directions, chunk: int = PLAIN_CHUNK,
                                stats: bool = False):
    """Plain PyTorch version of K6: nearest hit of every ray through the
    page-major plan and the 4-wide page trees. With ``stats`` it returns
    ``(hit, counters)`` (``traversal.new_stats``)."""
    origin, directions = _split_rays(origin, directions)
    _require_wide(scene)
    pg = scene.paged
    shape = directions.shape[:-1]
    perm, o_t, d_t = _tile_rays(origin, directions)
    item_pid, item_iid, mask = page_major_plan(scene, o_t, d_t)
    tile_start, tile_item = tile_lists(mask)
    dev = d_t.device
    r = d_t.shape[0]
    inst_tab = instance_table(scene)
    multi = scene.num_instances > 1
    t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    counters = new_stats(r, dev) if stats else None
    first = tile_start[:-1].long()
    count = tile_start[1:].long() - first  # items per tile
    chunk = max(chunk // TILE_RAYS, 1) * TILE_RAYS
    for lo in range(0, r, chunk):
        rays = torch.arange(lo, min(lo + chunk, r), device=dev)
        tile = rays // TILE_RAYS
        o = o_t.expand(rays.numel(), 3) if o_t.dim() == 1 else o_t[rays]
        # object-space rays of every instance: [I, n, 3] each
        obj = [object_ray(inst_tab[i], o, d_t[rays]) for i in range(scene.num_instances)]
        oo, od, inv = (torch.stack(x) for x in zip(*obj))
        for j in range(int(count[tile].max())):
            live = torch.nonzero(count[tile] > j).squeeze(1)
            item = tile_item[first[tile[live]] + j]
            pid = item_pid[item].long()
            iid = item_iid[item].long()
            g = rays[live]
            part = (t[g], tri[g], inst[g])
            sub = None if counters is None else {k: v[g] for k, v in counters.items()}
            walk_tree(pg.code, pg.box, 4, scene.tri_rec, pg.node_base[pid], 0,
                      pg.page_tri0[pid], oo[iid, live], od[iid, live], inv[iid, live],
                      iid if multi else -1, part, sub)
            t[g], tri[g], inst[g] = part
            if counters is not None:
                for k, v in sub.items():
                    counters[k][g] = v
    hit = finish_plain(t, tri, inst, (r,), scene.num_instances)
    hit = _hit(*(_untile(perm, x) for x in hit[:3]), shape)
    if counters is None:
        return hit
    return hit, {k: _untile(perm, v) for k, v in counters.items()}


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def cast_rays_paged_major_cuda(scene, origin, directions, short_stack: int | None = None):
    """K6: nearest hit through the page-major plan and the 4-wide page
    trees. CUDA tensors make the plan on the card and launch the kernel
    on the current stream, with ``short_stack`` ring slots per thread
    (default ``wide4.SHORT_STACK``), with no host sync; CPU tensors run
    the plain version."""
    origin, directions = _split_rays(origin, directions)
    if directions.device.type == "cpu":
        return cast_rays_paged_major_torch(scene, origin, directions)
    if scene.device != directions.device:
        raise ValueError(f"scene on {scene.device}, rays on {directions.device}")
    _require_wide(scene)
    s = check_short_stack(short_stack)
    perm, o_t, d_t = _tile_rays(origin, directions)
    pages, inst_tab = page_args(scene, d_t)
    item_pid, item_iid, tile_start, tile_item = page_major_plan_cuda(scene, o_t, d_t, inst_tab)
    r = d_t.shape[0]
    out = (torch.empty(r, dtype=torch.float32, device=d_t.device),
           torch.empty(r, dtype=torch.int32, device=d_t.device),
           torch.empty(r, dtype=torch.int32, device=d_t.device))
    launch("paged_major_launch", *pages, item_pid.data_ptr(), item_iid.data_ptr(),
           tile_start.data_ptr(), tile_item.data_ptr(), tile_start.shape[0] - 1,
           *ray_args(o_t, d_t, out), s, None, device=d_t.device, count=("K6",))
    return _hit(*(_untile(perm, x) for x in out), directions.shape[:-1])
