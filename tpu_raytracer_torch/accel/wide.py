"""Binary -> 4-wide and binary -> arity-2 BVH layouts (host side).

The port's own copy of ``tpu_raytracer/accel/wide.py`` (``collapse4``,
unchanged, so the port's 4-wide tables equal the JAX package's), plus
``collapse2``: the same child-code layout at arity 2, which the binary
in-page walk of the paged kernel (K5) reads with the traversal template
that walks the 4-wide tables.

Collapse rule (classic 2-level): wide node W(r) for binary internal r
has entries = for each child c of r: c itself if c is a leaf, else c's
two children. Entries that are internal binary nodes become wide child
nodes (recursively); leaf entries carry their (start, count) range
directly. All child ids live in the code table, so no preorder
invariant is required (wide ids are still assigned in DFS order for
locality).

Output encoding (consumed by kernels/wide4.py and kernels/paged.py):
  * wcode[A*w + c] (A = 4 or 2): internal -> wide child id; leaf ->
    -(start * 1024 + count) - 1; absent -> -1 (a count-0 leaf).
  * wbox[w, c]: child AABB (min xyz, max xyz); absent children get an
    inverted box (+BIG min, -BIG max) that can never pass a slab test.
  * wroot[m]: wide root per mesh.

A leaf code holds its start in the 21 bits above the 10-bit count, so
both collapses address leaves that start below ``LEAF_ROWS`` =
2,097,152 triangle rows and raise a ``ValueError`` for a leaf at or past
it. A scene of more rows is cast through page tables
(``SceneTensors.with_paging``), whose leaf starts are page-local and so
below ``LEAF_ROWS`` too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_BITS = 10  # a leaf code's count bits; the kernels read LEAF_BITS from here
_LEAF_SHIFT = 1 << LEAF_BITS
# First triangle row a leaf code cannot start at: 31 bits less the count's.
LEAF_ROWS = 1 << (31 - LEAF_BITS)
_BIG = np.float32(3.0e38)


@dataclasses.dataclass(frozen=True)
class Wide4Arrays:
    wcode: np.ndarray  # [A*W] i32
    wbox_min: np.ndarray  # [W, A, 3] f32
    wbox_max: np.ndarray  # [W, A, 3] f32
    wroot: np.ndarray  # [M] i32

    @property
    def num_nodes(self) -> int:
        return len(self.wbox_min)


def check_leaf_rows(child_a: np.ndarray, leaf_start: np.ndarray) -> None:
    """Raise unless every leaf starts below ``LEAF_ROWS``, the rows a leaf
    code can address."""
    starts = np.asarray(leaf_start)[np.asarray(child_a) < 0]
    if starts.size and int(starts.max()) >= LEAF_ROWS:
        raise ValueError(
            f"a leaf starts at triangle row {int(starts.max())}: leaf codes address rows "
            f"below {LEAF_ROWS} (LEAF_ROWS, a 21-bit start beside the 10-bit count); cast such "
            "a scene through page tables (SceneTensors.with_paging, which Scene.compile "
            "attaches with auto_page=True)")


def collapse4(
    child_a: np.ndarray,
    child_b: np.ndarray,
    leaf_start: np.ndarray,
    leaf_count: np.ndarray,
    node_min: np.ndarray,
    node_max: np.ndarray,
    mesh_root: np.ndarray,
) -> Wide4Arrays:
    """Collapse the merged binary BVH arrays (SceneArrays fields, as
    numpy) into the 4-wide layout. Pure host numpy, run once per scene
    at compile. Raises for a leaf at or past ``LEAF_ROWS``
    (``check_leaf_rows``)."""
    child_a = np.asarray(child_a)
    child_b = np.asarray(child_b)
    leaf_start = np.asarray(leaf_start)
    leaf_count = np.asarray(leaf_count)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    check_leaf_rows(child_a, leaf_start)
    is_leaf = child_a < 0

    def entries_of(r: int) -> list[int]:
        """Binary entry nodes of wide node W(r): children, with
        internal children expanded to their two children."""
        out = []
        for c in (int(child_a[r]), int(child_b[r])):
            if is_leaf[c]:
                out.append(c)
            else:
                out.append(int(child_a[c]))
                out.append(int(child_b[c]))
        return out

    wcode: list[int] = []
    wmin: list[np.ndarray] = []
    wmax: list[np.ndarray] = []

    wroot = np.zeros(len(mesh_root), np.int32)
    for m, root in enumerate(np.asarray(mesh_root)):
        root = int(root)
        # wide id assignment: DFS preorder over wide nodes of this mesh
        if is_leaf[root]:
            # degenerate single-leaf mesh: one wide node, one leaf entry
            wroot[m] = len(wmin)
            codes = [-(int(leaf_start[root]) * _LEAF_SHIFT
                       + int(leaf_count[root])) - 1, -1, -1, -1]
            mn = np.full((4, 3), _BIG, np.float32)
            mx = np.full((4, 3), -_BIG, np.float32)
            mn[0] = node_min[root]
            mx[0] = node_max[root]
            wcode.extend(codes)
            wmin.append(mn)
            wmax.append(mx)
            continue

        wroot[m] = len(wmin)
        # stack of (binary internal node, its assigned wide id)
        next_id = len(wmin) + 1
        # reserve slot for the root wide node
        wcode.extend([0, 0, 0, 0])
        wmin.append(np.zeros((4, 3), np.float32))
        wmax.append(np.zeros((4, 3), np.float32))
        stack = [(root, wroot[m])]
        while stack:
            r, wid = stack.pop()
            ents = entries_of(r)
            codes = [-1, -1, -1, -1]
            mn = np.full((4, 3), _BIG, np.float32)
            mx = np.full((4, 3), -_BIG, np.float32)
            for c, e in enumerate(ents):
                mn[c] = node_min[e]
                mx[c] = node_max[e]
                if is_leaf[e]:
                    codes[c] = -(int(leaf_start[e]) * _LEAF_SHIFT
                                 + int(leaf_count[e])) - 1
                else:
                    codes[c] = next_id
                    # reserve the child wide node
                    wcode.extend([0, 0, 0, 0])
                    wmin.append(np.zeros((4, 3), np.float32))
                    wmax.append(np.zeros((4, 3), np.float32))
                    stack.append((e, next_id))
                    next_id += 1
            wcode[4 * wid : 4 * wid + 4] = codes
            wmin[wid] = mn
            wmax[wid] = mx

    return Wide4Arrays(
        wcode=np.asarray(wcode, np.int32),
        wbox_min=np.stack(wmin) if wmin else np.zeros((0, 4, 3), np.float32),
        wbox_max=np.stack(wmax) if wmax else np.zeros((0, 4, 3), np.float32),
        wroot=wroot,
    )


def collapse2(
    child_a: np.ndarray,
    child_b: np.ndarray,
    leaf_start: np.ndarray,
    leaf_count: np.ndarray,
    node_min: np.ndarray,
    node_max: np.ndarray,
    mesh_root: np.ndarray,
) -> Wide4Arrays:
    """The binary BVH in the child-code layout at arity 2: one node per
    binary internal node (ids in node order, which is DFS preorder),
    whose two entries are its children; a mesh whose root is a leaf
    gets one node with that leaf as entry 0 and entry 1 absent, as
    ``collapse4`` builds it. Vectorized: no per-node Python work. Raises
    for a leaf at or past ``LEAF_ROWS`` (``check_leaf_rows``)."""
    check_leaf_rows(child_a, leaf_start)
    child_a = np.asarray(child_a)
    child_b = np.asarray(child_b)
    leaf_start = np.asarray(leaf_start).astype(np.int64)
    leaf_count = np.asarray(leaf_count).astype(np.int64)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    mesh_root = np.asarray(mesh_root).astype(np.int64)
    internal = child_a >= 0
    wid = np.cumsum(internal) - 1  # wide id of each internal node
    inner = np.nonzero(internal)[0]

    def code_of(c):
        return np.where(internal[c], wid[c], -(leaf_start[c] * _LEAF_SHIFT + leaf_count[c]) - 1)

    ents = np.stack([child_a[inner], child_b[inner]], axis=1)  # [W, 2]
    wcode = code_of(ents)
    wmin = node_min[ents]
    wmax = node_max[ents]
    leaf_roots = mesh_root[~internal[mesh_root]]
    wroot = np.where(internal[mesh_root], wid[mesh_root], 0)
    if leaf_roots.size:
        # degenerate single-leaf meshes: one extra node each
        extra = len(inner) + np.arange(leaf_roots.size)
        wroot[~internal[mesh_root]] = extra
        codes = np.full((leaf_roots.size, 2), -1, np.int64)
        codes[:, 0] = code_of(leaf_roots)
        mn = np.full((leaf_roots.size, 2, 3), _BIG, np.float32)
        mx = np.full((leaf_roots.size, 2, 3), -_BIG, np.float32)
        mn[:, 0] = node_min[leaf_roots]
        mx[:, 0] = node_max[leaf_roots]
        wcode = np.concatenate([wcode, codes])
        wmin = np.concatenate([wmin, mn])
        wmax = np.concatenate([wmax, mx])
    return Wide4Arrays(
        wcode=np.asarray(wcode, np.int32).reshape(-1),
        wbox_min=np.asarray(wmin, np.float32).reshape(-1, 2, 3),
        wbox_max=np.asarray(wmax, np.float32).reshape(-1, 2, 3),
        wroot=wroot.astype(np.int32),
    )
