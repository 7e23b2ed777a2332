"""Casts over the binary BVH: kernel K2 (the ``bvh`` backend), its tables
and its plain PyTorch version.

Counterpart of ``tpu_raytracer/kernels/traversal.py:_traversal_kernel``
(the binary packet kernel, with its tables ``_scene_kernel_inputs``) and
of ``render/renderer.py:cast_rays_bvh`` (the per-ray XLA walk of the same
tree, the JAX package's default backend). On the card one thread per ray
walking the binary tree is both, so both become K2: K1's walk
(``csrc/walk.cuh``) at arity 2, over every mesh's whole binary tree,
nearest or any hit.

The tables, in ``accel/wide.py:collapse2``'s child-code layout:

  * ``code [N, 2] i32``: one node per internal binary node (node order),
    its two children — internal -> node id; leaf ->
    -(start * 1024 + count) - 1; absent -> -1;
  * ``box [N, 12] f32``: the two children's boxes, NUDGE baked in
    (``kernels/paged.py:_records``, as ``_scene_kernel_inputs`` bakes it);
  * ``root [M] i32``: the node of each mesh root;
  * ``node [N, 16] f32``: the records K2 reads, derived from the two
    above (``wide4.node_records``): the 12 box floats, the 2 child codes'
    bits in lanes 12..13, zeros in 14..15. One 64-byte row per node, read
    as 16-byte loads; ``code``/``box`` stay for the plain version.

``collapse2`` gives a mesh whose root is a leaf one extra node with that
leaf as entry 0; here that entry's box is one every ray enters, so K2,
like both JAX binary walks, tests no mesh root's own box. (The 4-wide
tables of K1 keep that box, which culls a ray grazing such a mesh up to
EDGE_EPS outside it.) Its slab distances are infinite, never NaN: the
reciprocal direction is never 0 (``safe_reciprocal``).

  * ``cast_rays_binary_cuda`` is K2's wrapper: for CUDA tensors it
    launches the kernel (``csrc/wide_traverse.cu``,
    ``binary_traverse_kernel``) and counts the launch in
    ``build.LAUNCHES``; for CPU tensors it runs the plain version. A failed build or launch
    raises.
  * ``cast_rays_binary_torch`` is the plain version:
    ``traversal.walk_tree`` at arity 2 over the same tables, with the
    ``stats`` counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.wide import collapse2
from .paged import _records
from .traversal import BIG, PLAIN_CHUNK, _split_rays, cast_rays_tree_torch, launch
from .wide4 import STACK_SIZE, _wide_depth, node_records, stack_needed


@dataclasses.dataclass(frozen=True)
class BinaryTables:
    code: torch.Tensor  # [N, 2] i32
    box: torch.Tensor  # [N, 12] f32
    root: torch.Tensor  # [M] i32
    depth: int  # nodes on the longest root-to-leaf path
    node: torch.Tensor  # [N, 16] f32 node records (codes bit-cast)

    def to(self, device) -> "BinaryTables":
        return dataclasses.replace(self, code=self.code.to(device), box=self.box.to(device),
                                   root=self.root.to(device), node=self.node.to(device))


def build_binary(scene) -> BinaryTables:
    """The K2 tables of the scene's binary BVH, on the scene's device.
    Host work, once per scene."""
    f = lambda name: getattr(scene, name).cpu().numpy()
    mesh_root = f("mesh_root")
    w = collapse2(f("node_child_a"), f("node_child_b"), f("node_leaf_start"),
                  f("node_leaf_count"), f("node_min"), f("node_max"), mesh_root)
    code, box = _records(w, 2)
    leaf_root = f("node_child_a")[mesh_root] < 0
    entered = np.array([-BIG] * 3 + [BIG] * 3, np.float32)
    box[w.wroot[leaf_root], 0:6] = entered
    depth = _wide_depth(code, w.wroot)
    if stack_needed(depth, 2) > STACK_SIZE:
        raise ValueError(f"binary BVH depth {depth} overflows the {STACK_SIZE}-slot stack")
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(scene.device)
    return BinaryTables(code=t(code, np.int32), box=t(box, np.float32),
                        root=t(w.wroot, np.int32), depth=depth,
                        node=t(node_records(code, box), np.float32))


def binary_tables(scene) -> BinaryTables:
    if scene.binary is None:
        raise ValueError("scene has no binary tables: it needs paging "
                         "(SceneTensors.needs_paging) and is cast through its page tables")
    return scene.binary


def cast_rays_binary_torch(scene, origin, directions, occlusion: bool = False,
                           chunk: int = PLAIN_CHUNK, stats: bool = False, t_max: float = BIG):
    """Plain PyTorch version of K2: nearest hit (any hit with
    ``occlusion``) nearer than ``t_max`` of every ray over the scene's
    binary tables. With ``stats`` it returns ``(hit, counters)``
    (``traversal.new_stats``)."""
    tree = binary_tables(scene)
    return cast_rays_tree_torch(scene, tree.code, tree.box, 2, tree.root, origin, directions,
                                occlusion, chunk, stats, t_max=t_max)


def cast_rays_binary_cuda(scene, origin, directions, occlusion: bool = False,
                          short_stack: int | None = None, t_max: float = BIG):
    """K2: nearest (or, with ``occlusion``, any) hit nearer than
    ``t_max`` over the binary tables, every instance in index order. CUDA
    tensors launch the kernel on the current stream, with ``short_stack``
    ring slots per thread (``traversal.launch``); CPU tensors run the
    plain version."""
    origin, directions = _split_rays(origin, directions)
    if directions.device.type == "cpu":
        return cast_rays_binary_torch(scene, origin, directions, occlusion, t_max=t_max)
    return launch("wt_launch", scene, origin, directions, occlusion, arity=2,
                  short_stack=short_stack, t_max=t_max, count=("K2",))
