"""Treelet paging: cut the merged BVH into pages for the paged kernels.

The port's own copy of ``tpu_raytracer/accel/paging.py``, with the page
capacities as plain arguments. The builder emits DFS preorder and
reorders triangles leaf-contiguously in DFS leaf order, so EVERY subtree
occupies a contiguous node range [n, n + size_n) AND a contiguous
triangle range [tri_lo_n, tri_lo_n + tris_n): a page is a subtree,
addressed by its root node and its first triangle.

The partition is a maximal top-down cut: a node becomes a page root iff
its subtree fits the page capacity and its parent's doesn't. Nodes above
the cut plus the cut roots form the TOP TREE, compacted (rank-remapped)
into its own small tables; cut roots appear there as "portal leaves"
whose control word carries the page id. The original DFS preorder
restricted to top nodes keeps the `child_a = node + 1` implicit-left-
child invariant, so the top tree uses the packed-code scheme of the TLAS
(kernels/tlas.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Default page capacities, the JAX package's: a page holds at most 8192
# triangles (in the 8-aligned leaf layout) and 4096 binary nodes.
PAGE_TRIS = 8192
PAGE_NODES = 4096


@dataclasses.dataclass(frozen=True)
class PageTable:
    """Host-side page partition of one compiled scene."""

    # Top tree (compacted)
    top_code: np.ndarray  # [Nt] i32: internal -> rank(child_b); portal -> -(pid+1)
    top_child_min: np.ndarray  # [Nt, 2, 3] f32 child A/B box mins
    top_child_max: np.ndarray  # [Nt, 2, 3] f32 child A/B box maxs
    top_root: np.ndarray  # [M] i32 top rank of each mesh root
    # Pages, in ascending global-node order
    page_node0: np.ndarray  # [P] i32 global node id of the page root
    page_tri0: np.ndarray  # [P] i32 global id of the page's first triangle

    @property
    def num_pages(self) -> int:
        return len(self.page_node0)

    @property
    def num_top_nodes(self) -> int:
        return len(self.top_code)


def _subtree_extents(child_a, child_b, leaf_start, leaf_count):
    """Per-node subtree node count, PADDED triangle span and
    first-triangle id, fully vectorized (the naive reverse sweep is a
    45-second Python loop at 1M-triangle scale).

    DFS preorder makes every subtree a contiguous node range
    [i, end_i): end_i - 1 is the RIGHTMOST LEAF of i's subtree, reached
    by following child_b pointers, so pointer-jumping with doubling
    resolves all ends in O(N log depth). Leaf triangle ranges follow
    from searchsorted over the (ascending) leaf indices: the subtree's
    first leaf is the first leaf >= i, its last the last leaf < end_i.

    Spans are in the scene's 8-aligned leaf layout (scene.py): each
    leaf owns [start, start + ceil(count/8)*8), so spans tile the
    padded table contiguously and a subtree is one contiguous window."""
    n = len(child_a)
    idx = np.arange(n, dtype=np.int64)
    internal = child_a >= 0

    # rightmost-descendant chains: cur -> child_b while internal
    cur = np.where(internal, child_b, idx).astype(np.int64)
    for _ in range(64):  # doubling: covers depth <= 2^64
        nxt = cur[cur]
        if (nxt == cur).all():
            break
        cur = nxt
    end = cur + 1
    size = end - idx

    leaves = idx[~internal]  # ascending == DFS leaf order
    span = (leaf_count[leaves].astype(np.int64) + 7) // 8 * 8
    lo = leaf_start[leaves].astype(np.int64)
    # padded spans must tile contiguously in leaf order
    if len(leaves) > 1 and not (lo[1:] == lo[:-1] + span[:-1]).all():
        raise ValueError(
            "subtree triangle ranges not contiguous — BVH is not "
            "in DFS leaf order"
        )
    hi = lo + span
    first_leaf = np.searchsorted(leaves, idx, side="left")
    last_leaf = np.searchsorted(leaves, end - 1, side="right") - 1
    tri_lo = lo[first_leaf]
    tris = hi[last_leaf] - tri_lo
    return size, tris, tri_lo


def build_page_table(
    node_min: np.ndarray,
    node_max: np.ndarray,
    child_a: np.ndarray,
    child_b: np.ndarray,
    leaf_start: np.ndarray,
    leaf_count: np.ndarray,
    mesh_root: np.ndarray,
    page_tris: int = PAGE_TRIS,
    page_nodes: int = PAGE_NODES,
) -> PageTable:
    """Partition the merged BVH arrays (SceneArrays fields, as numpy)
    into a top tree + pages. Pure host numpy; run once per scene."""
    child_a = np.asarray(child_a)
    child_b = np.asarray(child_b)
    size, tris, tri_lo = _subtree_extents(
        child_a, child_b, np.asarray(leaf_start), np.asarray(leaf_count)
    )
    max_span = (int(np.asarray(leaf_count).max(initial=0)) + 7) // 8 * 8
    if max_span > page_tris:
        raise ValueError("a BVH leaf exceeds the page triangle capacity")

    n = len(child_a)
    in_top = np.zeros(n, bool)
    is_portal = np.zeros(n, bool)
    stack = list(np.asarray(mesh_root)[::-1])
    while stack:
        i = int(stack.pop())
        in_top[i] = True
        if size[i] <= page_nodes and tris[i] <= page_tris:
            is_portal[i] = True  # leaves always land here (size 1)
        else:
            stack.append(int(child_b[i]))
            stack.append(int(child_a[i]))

    top_ids = np.nonzero(in_top)[0]
    rank = np.full(n, -1, np.int64)
    rank[top_ids] = np.arange(len(top_ids))

    portal_ids = np.nonzero(is_portal)[0]  # ascending == DFS page order
    page_id = np.full(n, -1, np.int64)
    page_id[portal_ids] = np.arange(len(portal_ids))

    # Compacted top tree. Internal top nodes keep the implicit
    # child_a = rank + 1 rule (verified below); portals encode the page.
    top_code = np.where(
        is_portal[top_ids],
        -(page_id[top_ids] + 1),
        np.where(child_b[top_ids] >= 0, rank[child_b[top_ids]], 0),
    ).astype(np.int32)
    internal = ~is_portal[top_ids]
    if internal.any():
        ia = top_ids[internal]
        if not (rank[child_a[ia]] == rank[ia] + 1).all():
            raise ValueError("top tree lost the DFS implicit-left-child rule")

    ca_s = np.maximum(child_a[top_ids], 0)
    cb_s = np.maximum(child_b[top_ids], 0)
    top_child_min = np.stack([node_min[ca_s], node_min[cb_s]], axis=1)
    top_child_max = np.stack([node_max[ca_s], node_max[cb_s]], axis=1)

    return PageTable(
        top_code=top_code,
        top_child_min=np.asarray(top_child_min, np.float32),
        top_child_max=np.asarray(top_child_max, np.float32),
        top_root=rank[np.asarray(mesh_root)].astype(np.int32),
        page_node0=portal_ids.astype(np.int32),
        page_tri0=tri_lo[portal_ids].astype(np.int32),
    )
