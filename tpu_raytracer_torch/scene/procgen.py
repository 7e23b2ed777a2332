"""Procedural test geometry and textures, in numpy.

Counterpart of ``tpu_raytracer/scene/procgen.py`` for the ported
scenes: the unit cube, the flat board, the Cornell box walls,
icospheres, the displaced blob (the 82k-triangle bench mesh), the
colonnade (the ~1M-triangle paged-path scene), the checker and gradient
textures and the equirect sky gradient.
Each function keeps the JAX package's exact numpy arithmetic, so both
packages build bit-identical triangles.
"""

from __future__ import annotations

import numpy as np


def cube_obj(size: float = 1.0, with_uv: bool = True) -> str:
    """Axis-aligned cube OBJ centered at the origin, quads fan-split by
    the loader. Outward winding."""
    s = size / 2.0
    v = [
        (-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
        (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s),
    ]
    vt = [(0, 0), (1, 0), (1, 1), (0, 1)]
    # faces as 1-based vertex indices, counter-clockwise seen from outside
    faces = [
        (1, 2, 6, 5),  # -y
        (2, 3, 7, 6),  # +x
        (3, 4, 8, 7),  # +y
        (4, 1, 5, 8),  # -x
        (5, 6, 7, 8),  # +z
        (4, 3, 2, 1),  # -z
    ]
    lines = [f"v {x} {y} {z}" for x, y, z in v]
    if with_uv:
        lines += [f"vt {u} {w}" for u, w in vt]
        lines += [
            "f " + " ".join(f"{vi}/{ti}" for vi, ti in zip(f, (1, 2, 3, 4)))
            for f in faces
        ]
    else:
        lines += ["f " + " ".join(str(vi) for vi in f) for f in faces]
    return "\n".join(lines) + "\n"


def board_obj(w: float = 1.0, h: float = 1.0) -> str:
    """Flat textured board in the x/z plane facing -y (the calibration
    board analog, kernel.cu:234-240)."""
    lines = [
        f"v {-w/2} 0 {-h/2}", f"v {w/2} 0 {-h/2}",
        f"v {w/2} 0 {h/2}", f"v {-w/2} 0 {h/2}",
        "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
        "f 1/1 2/2 3/3 4/4",
    ]
    return "\n".join(lines) + "\n"


def cornell_box() -> dict[str, np.ndarray]:
    """Cornell-box walls as [2, 3, 3] triangle arrays keyed by wall name,
    each wall wound to face the box interior. The box spans [0, 2]^3 with
    the opening toward -y (the camera side); world is y-forward, z-up."""

    def quad(a, b, c, d):
        a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
        return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])

    return {
        "floor": quad((0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0)),  # z=0, normal +z
        "ceiling": quad((0, 0, 2), (0, 2, 2), (2, 2, 2), (2, 0, 2)),  # z=2, normal -z
        "back": quad((0, 2, 0), (2, 2, 0), (2, 2, 2), (0, 2, 2)),  # y=2, normal -y
        "left": quad((0, 0, 0), (0, 2, 0), (0, 2, 2), (0, 0, 2)),  # x=0, normal +x
        "right": quad((2, 0, 0), (2, 0, 2), (2, 2, 2), (2, 2, 0)),  # x=2, normal -x
    }


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Subdivided icosahedron: 20 * 4^n triangles (n=6 -> 81 920, the
    bunny-class BVH workload; n=3 -> 1 280)."""
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


def blob(subdivisions: int = 6, radius: float = 1.0, seed: int = 7) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bunny-stand-in: an icosphere displaced by smooth low-frequency
    noise so the BVH is as irregular as a scanned mesh (~20*4^n tris)."""
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


def colonnade(
    columns_x: int = 10,
    columns_y: int = 10,
    segs: int = 32,
    bands: int = 40,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sponza-class stress scene: a hall of fluted, entasis-profiled
    cylinders on a floor slab. Triangles ~= columns_x * columns_y *
    bands * segs * 2 (10x10x40x32 -> 256k)."""
    theta = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    flute = 0.05 * np.cos(theta * 8)

    heights = np.linspace(0.0, 3.2, bands + 1)
    # entasis: slight bulge toward the lower third, flared capitals
    prof = 0.3 + 0.03 * np.sin(np.pi * heights / 3.2)
    prof[0] *= 1.15
    prof[-1] *= 1.15

    # ring vertices per column template: [bands+1, segs, 3] (local)
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
    a = local[:-1, :, :]  # [bands, segs, 3]
    b = local[:-1, s2, :]
    c = local[1:, s2, :]
    d = local[1:, :, :]
    # two triangles per quad, outward winding
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    template = np.concatenate([t1, t2])  # [bands*segs*2, 3, 3]

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

    # floor slab
    w, h = columns_x * 2.0, columns_y * 2.0
    floor = np.asarray(
        [[(0, 0, 0), (w, 0, 0), (w, h, 0)], [(0, 0, 0), (w, h, 0), (0, h, 0)]],
        np.float32,
    )
    tris = np.concatenate([floor, tris])
    return tris[:, 0].copy(), tris[:, 1].copy(), tris[:, 2].copy()


def checkerboard_texture(size: int = 256, squares: int = 8) -> np.ndarray:
    """Calibration-board-like checker texture, [size, size, 3] uint8."""
    q = size // squares
    yy, xx = np.mgrid[0:size, 0:size]
    checker = ((xx // q + yy // q) % 2).astype(np.uint8)
    img = np.where(checker[..., None] == 0, 235, 25).astype(np.uint8)
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def gradient_texture(w: int = 128, h: int = 128) -> np.ndarray:
    """Smooth gradient texture for uv-mapping tests, [h, w, 3] uint8 in
    the engine's channel order (red along x, green along y)."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = (255 * xx / max(w - 1, 1)).astype(np.uint8)
    g = (255 * yy / max(h - 1, 1)).astype(np.uint8)
    b = np.full_like(r, 128)
    return np.stack([b, g, r], axis=-1)


def sky_gradient_texture(w: int = 256, h: int = 128) -> np.ndarray:
    """Equirect sky for ``Scene.set_sky``: a warm horizon band fading to a
    deep zenith blue over a grey ground, [h, w, 3] uint8 (row 0 is the
    zenith)."""
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    zen = np.array([230, 140, 60], np.float32)
    hor = np.array([120, 200, 250], np.float32)
    band = np.clip((v - 0.35) / 0.3, 0.0, 1.0)
    row = zen * (1.0 - band) + hor * band
    ground = np.array([60, 70, 80], np.float32)
    row = np.where(v > 0.55, ground, row)
    return np.broadcast_to(row[:, None, :], (h, w, 3)).astype(np.uint8)
