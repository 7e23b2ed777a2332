"""MeshPrimitive: triangle soup plus its BVH, on the host in numpy.

Counterpart of ``tpu_raytracer/scene/mesh.py``. The tree comes from the
port's own host builders (``accel/``): the sweep-SAH build with the JAX
package's defaults (``min_leaf_size=16``, ``max_depth=48``), in C++
(``accel/native.py``, built with g++ at first use) for meshes of at
least ``_NATIVE_MIN_TRIS`` triangles and in numpy below. The two give
identical trees, equal to the JAX package's, so triangle and node ids
equal its ids. A failed native build raises; it never falls back to the
numpy builder, which takes minutes on a million triangles. Triangles
are stored in BVH-leaf order, per-corner vertex normals (for smooth
shading) with them.

Not ported yet: the on-disk BVH cache (ROADMAP Queue 1 item 5) and
presplit for beyond-budget meshes (item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..accel import native
from ..accel.bvh import BVHArrays, build_bvh

# Meshes of at least this many triangles go to the native builder (the
# JAX package's threshold); smaller ones build fast enough in numpy.
_NATIVE_MIN_TRIS = 4096
# The JAX package's tree defaults: leaves of up to 16 triangles fit the
# kernels' 8-triangle rows; depth 48 covers deep grid scenes.
MIN_LEAF_SIZE = 16
MAX_DEPTH = 48


def _build_tree(v0, v1, v2) -> BVHArrays:
    if len(v0) >= _NATIVE_MIN_TRIS:
        return native.build_bvh_native(v0, v1, v2, max_depth=MAX_DEPTH,
                                       min_leaf_size=MIN_LEAF_SIZE)
    return build_bvh(v0, v1, v2, max_depth=MAX_DEPTH, min_leaf_size=MIN_LEAF_SIZE)


def _normalize_host(v: np.ndarray) -> np.ndarray:
    sq = np.sum(v * v, axis=-1, keepdims=True).astype(np.float32)
    return (v * (1.0 / np.sqrt(sq))).astype(np.float32)


@dataclasses.dataclass
class MeshPrimitive:
    """Triangle mesh with UVs, face normals and a built BVH, all in BVH
    leaf order (``bvh.order`` applied)."""

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray
    v2: np.ndarray
    normal: np.ndarray  # [T, 3] f32 face normals
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    bvh: BVHArrays
    # optional per-corner vertex normals for smooth shading, in (v0, v1,
    # v2) corner order; vn_mask flags the triangles whose face had them
    # (the others shade with the face normal)
    vn0: np.ndarray | None = None  # [T, 3] f32
    vn1: np.ndarray | None = None
    vn2: np.ndarray | None = None
    vn_mask: np.ndarray | None = None  # [T] bool

    @classmethod
    def from_triangles(cls, v0, v1, v2, normal=None, uv0=None, uv1=None,
                       uv2=None, vn0=None, vn1=None, vn2=None,
                       vn_mask=None) -> "MeshPrimitive":
        """Build from raw triangle arrays; face normals default to the
        normalized winding cross product. Vertex normals, where given,
        are permuted with the triangles."""
        v0 = np.asarray(v0, np.float32).reshape(-1, 3)
        v1 = np.asarray(v1, np.float32).reshape(-1, 3)
        v2 = np.asarray(v2, np.float32).reshape(-1, 3)
        num = len(v0)
        if normal is None:
            normal = _normalize_host(np.cross(v1 - v0, v2 - v0))
        else:
            normal = np.asarray(normal, np.float32).reshape(-1, 3)
        zeros_uv = np.zeros((num, 2), np.float32)
        uv0 = zeros_uv if uv0 is None else np.asarray(uv0, np.float32).reshape(-1, 2)
        uv1 = zeros_uv if uv1 is None else np.asarray(uv1, np.float32).reshape(-1, 2)
        uv2 = zeros_uv if uv2 is None else np.asarray(uv2, np.float32).reshape(-1, 2)

        bvh = _build_tree(v0, v1, v2)
        p = bvh.order
        kw = {}
        if vn0 is not None:
            kw = dict(vn0=np.asarray(vn0, np.float32).reshape(-1, 3)[p],
                      vn1=np.asarray(vn1, np.float32).reshape(-1, 3)[p],
                      vn2=np.asarray(vn2, np.float32).reshape(-1, 3)[p],
                      vn_mask=np.asarray(vn_mask, bool).reshape(-1)[p])
        return cls(
            v0=v0[p], v1=v1[p], v2=v2[p], normal=normal[p],
            uv0=uv0[p], uv1=uv1[p], uv2=uv2[p], bvh=bvh, **kw,
        )

    @property
    def num_triangles(self) -> int:
        return len(self.v0)
