"""Wavefront OBJ loader (reference: CudaRaytracer/OBJLoader.hpp:12-181).

Counterpart of ``tpu_raytracer/scene/objloader.py``: polygon faces are
fan-triangulated as (0, i, i+1); UVs attach only when every token of a
face carries a ``vt`` index; face normals are recomputed from the
winding; ``vn`` records give per-corner vertex normals on request
(``vertex_normals=True``). ``load`` reads a file (a missing one raises
``FileNotFoundError``), ``loads`` a string. ``parse_obj`` sends texts
above ``NATIVE_OBJ_THRESHOLD`` characters to the native C++ parser
(``native_obj.py``, bit for bit the numpy parser's results) and smaller
ones to the numpy parser; ``native=`` forces either.
"""

from __future__ import annotations

import numpy as np

from .mesh import MeshPrimitive


# Texts above this many characters go to the native parser (the JAX
# package's threshold): below it the numpy parser is fast enough.
NATIVE_OBJ_THRESHOLD = 256 * 1024


def parse_obj(text: str, native: bool | None = None):
    """OBJ text -> raw triangle arrays (v0, v1, v2, uv0, uv1, uv2, has_uv),
    by the native parser above ``NATIVE_OBJ_THRESHOLD`` characters or
    where ``native`` is True, by the numpy parser otherwise."""
    if native is None:
        native = len(text) > NATIVE_OBJ_THRESHOLD
    if native:
        from .native_obj import parse_obj_native

        return parse_obj_native(text)
    return _parse_obj_py(text)


def _parse_obj_py(text: str):
    """The numpy parser (small texts, and the native parser's oracle)."""
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


def parse_obj_vertex_normals(text: str):
    """Per-corner vertex normals of the ``vn`` records, over the same
    faces in the same fan order as ``parse_obj``: a face's normals
    attach only when every token carries a ``vn`` index (``v//vn`` or
    ``v/vt/vn``); other faces keep their face normal. Returns (vn0, vn1,
    vn2 [T, 3] f32, mask [T] bool)."""
    normals: list[list[float]] = []
    tri_n: list[tuple[int, int, int] | None] = []
    for line in text.splitlines():
        tokens = line.split()
        if not tokens:
            continue
        tag = tokens[0]
        if tag == "vn":
            normals.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
        elif tag == "f":
            n_idx: list[int] = []
            n_face = len(tokens) - 1
            for tok in tokens[1:]:
                parts = tok.split("/")
                if len(parts) > 2 and parts[2] != "":
                    n_idx.append(int(parts[2]) - 1)
            has_n = len(n_idx) == n_face
            for i in range(1, n_face - 1):
                tri_n.append((n_idx[0], n_idx[i], n_idx[i + 1]) if has_n else None)
    ns = (np.asarray(normals, np.float32).reshape(-1, 3) if normals
          else np.zeros((0, 3), np.float32))
    mask = np.array([n is not None for n in tri_n], bool)
    vn = [np.zeros((len(tri_n), 3), np.float32) for _ in range(3)]
    if mask.any():
        idx = np.asarray([n for n in tri_n if n is not None], np.int64).reshape(-1, 3)
        for c in range(3):
            vn[c][mask] = ns[idx[:, c]]
    return vn[0], vn[1], vn[2], mask


def load(fp: str, max_depth: int = 48, exact_normals: bool = True,
         vertex_normals: bool = False) -> MeshPrimitive:
    """Load an OBJ file into a MeshPrimitive (BVH built in the
    constructor, as OBJLoader.hpp:177 -> MeshPrimitive.cpp:5-15)."""
    with open(fp) as f:
        text = f.read()
    mesh = loads(text, max_depth=max_depth, exact_normals=exact_normals,
                 vertex_normals=vertex_normals)
    print(f"OBJ File: {fp}")
    print(f"Loaded {mesh.num_triangles} triangles")
    return mesh


def loads(text: str, max_depth: int = 48, exact_normals: bool = True,
          vertex_normals: bool = False) -> MeshPrimitive:
    """OBJ source text -> MeshPrimitive (BVH built in the constructor).
    ``vertex_normals`` attaches the file's ``vn`` records for smooth
    shading (none where no face has complete ones); ``max_depth`` and
    ``exact_normals`` are ``MeshPrimitive.from_triangles``'."""
    v0, v1, v2, uv0, uv1, uv2, _ = parse_obj(text)
    vn = (None,) * 4
    if vertex_normals:
        vn = parse_obj_vertex_normals(text)
        if not vn[3].any():
            vn = (None,) * 4
    return MeshPrimitive.from_triangles(v0, v1, v2, None, uv0, uv1, uv2, max_depth=max_depth,
                                        exact_normals=exact_normals, vn0=vn[0], vn1=vn[1],
                                        vn2=vn[2], vn_mask=vn[3])
