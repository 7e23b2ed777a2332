"""Tables of the 4-wide BVH traversal (kernel K1).

Counterpart of ``tpu_raytracer/kernels/wide4.py`` (``build_wide4``) and
of the triangle records of ``kernels/traversal.py:_scene_kernel_inputs``,
laid out for one thread per ray instead of 128-lane TPU rows:

  * ``wcode [W, 4] i32``: child c of wide node w — internal -> wide
    child id; leaf -> -(start * 1024 + count) - 1; absent -> -1 (a
    count-0 leaf). From ``accel/wide.py:collapse4``.
  * ``wbox [W, 32] f32``: child c's box (min xyz, max xyz) in lanes
    c*6 .. c*6+5 with the watertight NUDGE baked in; absent children
    carry inverted boxes. Lanes 24..31 are zero.
  * ``wnode [W, 32] f32``: the record K1 and K3 read (``csrc/walk.cuh``),
    derived from the two above by ``node_records``: ``wbox``'s 24 box
    floats with the 4 child codes bit-cast into lanes 24..27. One 128-byte
    row per node, read as 16-byte loads. ``wcode`` and ``wbox`` stay for
    the plain version.
  * ``tri_rec [T, 16] f32``: v0, face normal, rA, rB (the affine
    barycentric rows of ``intersect.barycentric_rows``) and 4 zero lanes
    (``build_tri_rec``). Every compiled scene holds them as
    ``SceneTensors.tri_rec``, which the paged kernels K4-K6 read too; a
    scene past the leaf code's rows (``accel/wide.py LEAF_ROWS``) has
    them and page tables, and no 4-wide tables.
  * ``wroot [M] i32`` (wide root per mesh), ``max_leaf`` (largest leaf
    triangle count) and ``depth`` (wide-tree depth, which bounds the
    per-ray stack).

``wide_sah`` gives each mesh's SAH cost over these tables, as
``accel/bvh.py sah_cost`` gives it over the binary tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import _half_area
from ..accel.wide import LEAF_BITS, collapse4
from ..render.intersect import WATERTIGHT_NUDGE, barycentric_rows

NUDGE = WATERTIGHT_NUDGE
REC32 = 32  # f32 lanes per wide-node record
STACK_SIZE = 192  # per-ray traversal stack (csrc/wide_traverse.cuh kStack)
# The short stack of K1-K6: ring slots per thread in shared memory
# (csrc/walk.cuh ShortStack; a power of two, at most 64). 4, 8, 16 and
# 32 measured within 2% of each other on every ray set (PERF.md section 6).
SHORT_STACK = 8


def stack_needed(depth: int, arity: int = 4) -> int:
    """Stack slots a depth-``depth`` tree of ``arity`` can need: each pop
    takes one node and pushes at most ``arity``, so the stack holds at
    most ``arity - 1`` siblings per level on the current path, plus
    slack."""
    return (arity - 1) * depth + 4


@dataclasses.dataclass(frozen=True)
class Wide4Tables:
    wcode: torch.Tensor  # [W, 4] i32
    wbox: torch.Tensor  # [W, 32] f32
    tri_rec: torch.Tensor  # [T, 16] f32
    wroot: torch.Tensor  # [M] i32
    max_leaf: int
    depth: int
    wnode: torch.Tensor  # [W, 32] f32 (codes bit-cast)

    def to(self, device) -> "Wide4Tables":
        return dataclasses.replace(
            self, wcode=self.wcode.to(device), wbox=self.wbox.to(device),
            tri_rec=self.tri_rec.to(device), wroot=self.wroot.to(device),
            wnode=self.wnode.to(device),
        )


def node_records(code: np.ndarray, box: np.ndarray) -> np.ndarray:
    """The node records ``csrc/walk.cuh`` reads, [W, 8A] f32, of a tree
    of arity A = ``code.shape[1]`` (4 or 2) in the child-code layout
    (``code [W, A]``, ``box [W, >= 6A]``): the 6A box floats, the A
    child codes' bits in lanes 6A .. 7A-1, zeros after them. At A = 4
    that is ``wbox`` with the codes in lanes 24..27 (``wnode``); at A = 2
    a 64-byte record, codes in lanes 12..13."""
    arity = code.shape[1]
    rec = np.zeros((code.shape[0], 8 * arity), np.float32)
    rec[:, :6 * arity] = box[:, :6 * arity]
    rec[:, 6 * arity:7 * arity] = np.ascontiguousarray(code, np.int32).view(np.float32)
    return rec


def _levels(wcode: np.ndarray, roots):
    """The ids of the wide nodes under ``roots``, level by level, the
    roots' first."""
    level = np.unique(roots)
    while level.size:
        yield level
        codes = wcode[level].reshape(-1)
        level = codes[codes >= 0]


def _wide_depth(wcode: np.ndarray, wroot: np.ndarray) -> int:
    """Depth of the deepest wide node below any root (a root alone is 1)."""
    return sum(1 for _ in _levels(wcode, wroot))


def build_tri_rec(scene) -> torch.Tensor:
    """The triangle records of the scene's rows, [T, 16] f32 on the
    scene's device."""
    v0 = scene.tri_v0.cpu()
    ra, rb = barycentric_rows(v0, scene.tri_v1.cpu(), scene.tri_v2.cpu())
    return torch.cat(
        [v0, scene.tri_normal.cpu(), ra, rb, torch.zeros(v0.shape[0], 4)], dim=1
    ).contiguous().to(scene.device)


def build_wide4(scene, tri_rec: torch.Tensor) -> Wide4Tables:
    """Collapse the scene's binary BVH and pack the K1 tables, on the
    scene's device, with the triangle records ``tri_rec``
    (``build_tri_rec``). Host work, once per scene; raises for a scene
    with a leaf past ``accel/wide.py LEAF_ROWS``."""
    f = lambda name: getattr(scene, name).cpu().numpy()
    w = collapse4(
        f("node_child_a"), f("node_child_b"), f("node_leaf_start"),
        f("node_leaf_count"), f("node_min"), f("node_max"), f("mesh_root"),
    )
    n = w.num_nodes
    wbox = np.zeros((n, REC32), np.float32)
    for c in range(4):
        wbox[:, 6 * c:6 * c + 3] = w.wbox_min[:, c] - np.float32(NUDGE)
        wbox[:, 6 * c + 3:6 * c + 6] = w.wbox_max[:, c] + np.float32(NUDGE)
    wcode = w.wcode.reshape(n, 4)
    depth = _wide_depth(wcode, w.wroot)
    if stack_needed(depth) > STACK_SIZE:
        raise ValueError(
            f"wide BVH depth {depth} needs {stack_needed(depth)} stack slots; "
            f"the traversal kernel has {STACK_SIZE}")
    is_leaf = f("node_child_a") < 0
    counts = f("node_leaf_count")[is_leaf]

    dev = scene.device
    return Wide4Tables(
        wcode=torch.from_numpy(np.ascontiguousarray(wcode, np.int32)).to(dev),
        wbox=torch.from_numpy(wbox).to(dev),
        tri_rec=tri_rec,
        wroot=torch.from_numpy(w.wroot.astype(np.int32)).to(dev),
        max_leaf=int(counts.max()) if counts.size else 0,
        depth=depth,
        wnode=torch.from_numpy(node_records(wcode, wbox)).to(dev),
    )


def wide_sah(tables: Wide4Tables) -> list[tuple[float, int]]:
    """``(cost, triangles)`` of each mesh's 4-wide tree, in ``wroot``
    order: ``sah_cost`` with ``c_trav = c_isect = 1`` over the boxes K1
    tests (``wbox``, nudged). The half-area of every wide node under the
    mesh's root (a node's box the union of its children's) over the
    root's, plus each leaf's half-area times its triangles over the
    root's; ``triangles`` is the leaves' sum."""
    code = tables.wcode.cpu().numpy()
    box = tables.wbox.cpu().numpy()[:, :24].reshape(-1, 4, 6)
    count = np.where(code < 0, (-code - 1) & ((1 << LEAF_BITS) - 1), 0)
    present = ((code >= 0) | (count > 0))[..., None]
    node_area = _half_area(np.where(present, box[..., :3], np.inf).min(1),
                           np.where(present, box[..., 3:], -np.inf).max(1))
    leaf = (count > 0)[..., None]  # absent children's inverted boxes left out
    leaf_area = _half_area(np.where(leaf, box[..., :3], 0), np.where(leaf, box[..., 3:], 0))
    leaf_cost = (leaf_area * count).sum(1)
    out = []
    for root in tables.wroot.cpu().numpy():
        nodes = np.concatenate(list(_levels(code, [root])))
        cost = node_area[nodes].sum(dtype=np.float64) + leaf_cost[nodes].sum(dtype=np.float64)
        out.append((float(cost / max(float(node_area[root]), 1e-30)), int(count[nodes].sum())))
    return out
