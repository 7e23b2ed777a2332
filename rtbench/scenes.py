"""A configuration's scene, made here so that a later change to the port
cannot move it.

``scene(config)`` gives the scene's description, which the port's side
(``system.py``) and the reference (``reference.py``) both build from:

  * ``meshes``: each a dict of ``MeshPrimitive.from_triangles`` keywords:
    ``v0``, ``v1``, ``v2`` (``[T, 3]`` float32) and, optionally, ``uv0``-
    ``uv2``, ``normal``, ``vn0``-``vn2``;
  * ``materials``: each a dict of ``Material`` fields, ``texture`` an
    ``[H, W, 3]`` uint8 array or absent;
  * ``instances``: each ``(mesh, material, pose[6], scale[3])``, the pose
    an lre (x, y, z, yaw, pitch, roll) as ``MeshInstance`` takes it.

A configuration's ``"generator"`` is one of ``GENERATORS``, the frozen
copies below, or the name of a file ``generators/<name>.py`` that defines
``scene(**args)`` returning a description. Either takes its arguments
from the configuration's ``"args"``.

``icosphere``, ``blob`` and ``colonnade`` copy
``tpu_raytracer_torch/scene/procgen.py`` (functions of the same names)
line for line, so both give bit-identical triangles
(``tests/test_rtbench_frozen.py`` holds them to it). Each returns
``(v0, v1, v2)``, three ``[T, 3]`` float32 arrays: one mesh, under one
``Material(albedo=config["albedo"])`` and one identity instance.
"""

from __future__ import annotations

import numpy as np

from . import spec


def icosphere(subdivisions: int = 3, radius: float = 1.0):
    """Copy of ``procgen.icosphere``: a subdivided icosahedron, 20 * 4^n
    triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        m01 = (v0 + v1) / 2
        m12 = (v1 + v2) / 2
        m20 = (v2 + v0) / 2
        for m in (m01, m12, m20):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        n = len(verts)
        k = len(faces)
        verts = np.concatenate([verts, m01, m12, m20])
        i01 = n + np.arange(k)
        i12 = n + k + np.arange(k)
        i20 = n + 2 * k + np.arange(k)
        faces = np.concatenate(
            [
                np.stack([faces[:, 0], i01, i20], 1),
                np.stack([faces[:, 1], i12, i01], 1),
                np.stack([faces[:, 2], i20, i12], 1),
                np.stack([i01, i12, i20], 1),
            ]
        )
    verts = (verts * radius).astype(np.float32)
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def blob(subdivisions: int = 6, radius: float = 1.0, seed: int = 7):
    """Copy of ``procgen.blob``: the bunny stand-in, an icosphere displaced
    by smooth low-frequency noise (81,920 triangles at 6 subdivisions)."""
    v0, v1, v2 = icosphere(subdivisions, radius)
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(8, 3)).astype(np.float32) * 2.0
    phases = rng.uniform(0, 2 * np.pi, 8).astype(np.float32)
    amps = (rng.uniform(0.02, 0.08, 8) * radius).astype(np.float32)

    def displace(v):
        d = np.zeros(len(v), np.float32)
        for f, p, a in zip(freqs, phases, amps):
            d += a * np.sin(v @ f + p)
        n = v / np.linalg.norm(v, axis=1, keepdims=True)
        return (v + n * d[:, None]).astype(np.float32)

    return displace(v0), displace(v1), displace(v2)


def colonnade(columns_x: int = 10, columns_y: int = 10, segs: int = 32, bands: int = 40):
    """Copy of ``procgen.colonnade``: the Sponza stand-in, a hall of
    fluted columns on a floor slab (256,002 triangles at 10 x 10 columns
    and 32 segments)."""
    theta = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    flute = 0.05 * np.cos(theta * 8)

    heights = np.linspace(0.0, 3.2, bands + 1)
    prof = 0.3 + 0.03 * np.sin(np.pi * heights / 3.2)
    prof[0] *= 1.15
    prof[-1] *= 1.15

    radii = prof[:, None] + flute[None, :]
    local = np.stack(
        [
            radii * cos_t[None, :],
            radii * sin_t[None, :],
            np.broadcast_to(heights[:, None], radii.shape),
        ],
        axis=-1,
    ).astype(np.float32)

    s2 = (np.arange(segs) + 1) % segs
    a = local[:-1, :, :]
    b = local[:-1, s2, :]
    c = local[1:, s2, :]
    d = local[1:, :, :]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    template = np.concatenate([t1, t2])

    offsets = np.stack(
        np.meshgrid(
            np.arange(columns_x) * 2.0 + 1.0,
            np.arange(columns_y) * 2.0 + 1.0,
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 2)
    tris = template[None, :, :, :] + np.concatenate(
        [offsets, np.zeros((len(offsets), 1))], axis=1
    ).astype(np.float32)[:, None, None, :]
    tris = tris.reshape(-1, 3, 3)

    w, h = columns_x * 2.0, columns_y * 2.0
    floor = np.asarray(
        [[(0, 0, 0), (w, 0, 0), (w, h, 0)], [(0, 0, 0), (w, h, 0), (0, h, 0)]],
        np.float32,
    )
    tris = np.concatenate([floor, tris])
    return tris[:, 0].copy(), tris[:, 1].copy(), tris[:, 2].copy()


# a configuration's "generator" names one of these or a file of generators/
GENERATORS = {"icosphere": icosphere, "blob": blob, "colonnade": colonnade}


def scene(config: dict) -> dict:
    """The configuration's scene description."""
    name = config["generator"]
    if name in GENERATORS:
        v0, v1, v2 = GENERATORS[name](**config["args"])
        return {"meshes": [{"v0": v0, "v1": v1, "v2": v2}],
                "materials": [{"albedo": tuple(config["albedo"])}],
                "instances": [(0, 0, np.zeros(6, np.float32), np.ones(3, np.float32))]}
    return spec.module("generators", name).scene(**config["args"])


def triangle_count(desc: dict) -> int:
    """The triangles the scene stores: the sum over its meshes."""
    return sum(len(m["v0"]) for m in desc["meshes"])
