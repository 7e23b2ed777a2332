"""BASELINE config 4, the port's ``app/scenes.py scene_instances``: a
textured 8 x 8 board, a mirror sphere, a red cube scaled (0.8, 0.8, 1.4)
and a half-size matte sphere, four posed instances of three meshes under
four materials. The board's pose (roll pi about y) leaves ``board_obj``'s
x/z plane upright: a wall at y = 2 facing -y, which the mirror sphere
pierces and behind which the small sphere sits.

The meshes and the texture are frozen copies, so that a later change to
the port cannot move the scene (``rtbench/tests/test_rtbench_whitted.py``
holds each to the port's):

  * the spheres: ``scenes.icosphere`` (``procgen.icosphere``);
  * ``cube`` and ``board``: the triangles, uvs and face normals that
    ``objloader.loads`` makes of ``procgen.cube_obj()`` and
    ``procgen.board_obj(8, 8)`` (polygons fan-split as (0, i, i + 1),
    each corner's ``vt``, the normal the normalised winding cross
    product), in the files' face order;
  * ``checkerboard``: ``procgen.checkerboard_texture(128, 8)``.
"""

from __future__ import annotations

import numpy as np

from rtbench import scenes


def _fan(verts, uvs, faces):
    """Triangles of 1-based ``v/vt`` polygons fan-split as the OBJ loader
    splits them: ``v0``-``v2``, ``uv0``-``uv2`` and ``normal``."""
    verts, uvs = np.asarray(verts, np.float32), np.asarray(uvs, np.float32)
    tri_v, tri_t = [], []
    for face in faces:
        for i in range(1, len(face) - 1):
            tri_v.append((face[0][0] - 1, face[i][0] - 1, face[i + 1][0] - 1))
            tri_t.append((face[0][1] - 1, face[i][1] - 1, face[i + 1][1] - 1))
    iv, it = np.asarray(tri_v, np.int64), np.asarray(tri_t, np.int64)
    v0, v1, v2 = verts[iv[:, 0]], verts[iv[:, 1]], verts[iv[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    sq = np.sum(n * n, axis=-1, keepdims=True).astype(np.float32)
    return {"v0": v0, "v1": v1, "v2": v2, "uv0": uvs[it[:, 0]], "uv1": uvs[it[:, 1]],
            "uv2": uvs[it[:, 2]], "normal": (n * (1.0 / np.sqrt(sq))).astype(np.float32)}


def cube(size: float = 1.0):
    """``objloader.loads(procgen.cube_obj(size))``: an axis-aligned cube
    about the origin, each face's quad split in two, outward winding."""
    s = size / 2.0
    verts = [(-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
             (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    quads = [(1, 2, 6, 5), (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8), (5, 6, 7, 8), (4, 3, 2, 1)]
    return _fan(verts, uvs, [list(zip(q, (1, 2, 3, 4))) for q in quads])


def board(w: float = 1.0, h: float = 1.0):
    """``objloader.loads(procgen.board_obj(w, h))``: a flat board in the
    x/z plane facing -y, two triangles."""
    verts = [(-w / 2, 0, -h / 2), (w / 2, 0, -h / 2), (w / 2, 0, h / 2), (-w / 2, 0, h / 2)]
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    return _fan(verts, uvs, [[(1, 1), (2, 2), (3, 3), (4, 4)]])


def checkerboard(size: int = 256, squares: int = 8) -> np.ndarray:
    """``procgen.checkerboard_texture(size, squares)``: [size, size, 3]
    uint8 squares of 235 and 25."""
    q = size // squares
    yy, xx = np.mgrid[0:size, 0:size]
    checker = ((xx // q + yy // q) % 2).astype(np.uint8)
    img = np.where(checker[..., None] == 0, 235, 25).astype(np.uint8)
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def scene(sphere_subdivisions: int = 4):
    """``scene_instances``' description: meshes sphere, cube, board;
    materials matte, red, mirror, textured; instances board, mirror
    sphere, cube, small sphere, with their poses and scales."""
    v0, v1, v2 = scenes.icosphere(sphere_subdivisions)
    f = lambda *x: np.array(x, np.float32)
    one = f(1.0, 1.0, 1.0)
    return {
        "meshes": [{"v0": v0, "v1": v1, "v2": v2}, cube(), board(8, 8)],
        "materials": [{"albedo": (0.9, 0.9, 0.9)},
                      {"albedo": (0.9, 0.2, 0.1)},
                      {"albedo": (0.95, 0.95, 0.95), "reflectivity": 0.8},
                      {"albedo": (1.0, 1.0, 1.0), "texture": checkerboard(128, 8)}],
        "instances": [(2, 3, f(0.0, 2.0, -1.2, 0.0, 0.0, np.pi), one),
                      (0, 2, f(-1.2, 2.5, 0.0, 0.0, 0.0, 0.0), one),
                      (1, 1, f(1.1, 2.0, -0.6, 0.5, 0.0, 0.0), f(0.8, 0.8, 1.4)),
                      (0, 0, f(0.3, 3.5, -0.7, 0.0, 0.0, 0.0), f(0.5, 0.5, 0.5))],
    }
