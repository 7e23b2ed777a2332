"""Wavefront OBJ loader from text, in numpy.

Counterpart of ``tpu_raytracer/scene/objloader.py`` (its pure-Python
parser): polygon faces are fan-triangulated as (0, i, i+1); UVs attach
only when every token of a face carries a ``vt`` index; face normals are
recomputed from the winding. Vertex normals and the native parser for
large files are not ported yet (ROADMAP item 15).
"""

from __future__ import annotations

import numpy as np

from .mesh import MeshPrimitive


def parse_obj(text: str):
    """OBJ text -> raw triangle arrays (v0, v1, v2, uv0, uv1, uv2, has_uv)."""
    vertices: list[list[float]] = []
    tex_coords: list[list[float]] = []
    tri_v: list[tuple[int, int, int]] = []
    tri_t: list[tuple[int, int, int] | None] = []

    for line in text.splitlines():
        tokens = line.split()
        if not tokens:
            continue
        tag = tokens[0]
        if tag == "v":
            vertices.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
        elif tag == "vt":
            tex_coords.append([float(tokens[1]), float(tokens[2])])
        elif tag == "f":
            v_idx: list[int] = []
            t_idx: list[int] = []
            for tok in tokens[1:]:
                parts = tok.split("/")
                v_idx.append(int(parts[0]) - 1)
                if len(parts) > 1 and parts[1] != "":
                    t_idx.append(int(parts[1]) - 1)
            textured = len(t_idx) == len(v_idx)
            for i in range(1, len(v_idx) - 1):
                tri_v.append((v_idx[0], v_idx[i], v_idx[i + 1]))
                tri_t.append((t_idx[0], t_idx[i], t_idx[i + 1]) if textured else None)

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    uvs = (
        np.asarray(tex_coords, np.float32).reshape(-1, 2)
        if tex_coords
        else np.zeros((0, 2), np.float32)
    )
    iv = np.asarray(tri_v, np.int64).reshape(-1, 3)
    v0, v1, v2 = verts[iv[:, 0]], verts[iv[:, 1]], verts[iv[:, 2]]

    has_uv = np.array([t is not None for t in tri_t], bool)
    uv0 = np.zeros((len(iv), 2), np.float32)
    uv1 = np.zeros((len(iv), 2), np.float32)
    uv2 = np.zeros((len(iv), 2), np.float32)
    if has_uv.any():
        it = np.asarray([t for t in tri_t if t is not None], np.int64).reshape(-1, 3)
        uv0[has_uv] = uvs[it[:, 0]]
        uv1[has_uv] = uvs[it[:, 1]]
        uv2[has_uv] = uvs[it[:, 2]]
    return v0, v1, v2, uv0, uv1, uv2, has_uv


def loads(text: str) -> MeshPrimitive:
    """OBJ source text -> MeshPrimitive (BVH built in the constructor)."""
    v0, v1, v2, uv0, uv1, uv2, _ = parse_obj(text)
    return MeshPrimitive.from_triangles(v0, v1, v2, None, uv0, uv1, uv2)
