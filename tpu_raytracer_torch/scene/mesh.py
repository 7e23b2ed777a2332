"""MeshPrimitive: triangle soup plus its BVH, on the host in numpy.

Counterpart of ``tpu_raytracer/scene/mesh.py``. The tree comes from the
port's own host builders (``accel/``), with the JAX package's defaults
(``min_leaf_size=16``, ``max_depth=48``) and its build options as
arguments of ``from_triangles``:

  * ``builder``: ``"auto"`` and ``"sweep"`` build the sweep-SAH tree, in
    C++ (``accel/native.py``, built with g++ at first use) for meshes of
    at least ``_NATIVE_MIN_TRIS`` triangles and in numpy below;
    ``"numpy"`` builds it in numpy at any size; ``"native"`` builds the
    reference's 5-candidate tree (``build_bvh(mode="reference")``, in
    numpy here, in C++ in the JAX package: the same tree). A failed
    native build raises; it never falls back to numpy, which takes
    minutes on a million triangles.
  * ``presplit`` (a split budget factor; ``accel/presplit.py``) and
    ``presplit_gate``: by default 1.3 exactly on meshes of more than
    ``PRESPLIT_ABOVE_TRIS`` triangles, the JAX package's rule, so both
    packages build the same tree at every size. A presplit build goes
    through numpy (the C++ builder has no entry for references).
  * ``opt_rounds``: rounds of the reinsertion optimizer
    (``accel/optimize.py``), under the same ``max_depth``.
  * ``exact_normals=False``: face normals normalised by the reference's
    ``q_rsqrt`` (``core/vecmath.py``, bit for bit the JAX package's).
  * ``cache_dir``: trees of meshes of at least ``CACHE_MIN_TRIS``
    triangles are kept on disk, keyed by a hash of the builder version,
    the options and the vertices (``default_cache_dir()`` unless given;
    ``False`` turns the cache off). An entry is written to a temporary
    file and renamed into place, and one that fails to load is deleted
    and rebuilt.

All builds give identical trees to the JAX package's for the same
options, so triangle and node ids equal its ids. Triangles are stored
in BVH-leaf order, per-corner vertex normals (for smooth shading) with
them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile
import zlib

import numpy as np
import torch

from ..accel import native
from ..accel.bvh import BVHArrays, build_bvh, sah_cost
from ..core.vecmath import q_rsqrt
from ..utils.profiling import setup

# Meshes of at least this many triangles go to the native builder (the
# JAX package's threshold); smaller ones build fast enough in numpy.
_NATIVE_MIN_TRIS = 4096
# The JAX package's tree defaults: leaves of up to 16 triangles fit the
# kernels' 8-triangle rows; depth 48 covers deep grid scenes.
MIN_LEAF_SIZE = 16
MAX_DEPTH = 48
BUILDERS = ("auto", "sweep", "numpy", "native")
# The JAX package's presplit rule (scene/mesh.py _paged_only_size):
# budget 1.3 on meshes of more than this many triangles, none below. It
# is that package's threshold, kept so both build the same trees.
PRESPLIT_ABOVE_TRIS = 1_310_712
PRESPLIT_FACTOR = 1.3
PRESPLIT_GATE = 16.0
# Meshes of at least this many triangles use the disk cache; smaller
# builds are faster than hashing and file IO.
CACHE_MIN_TRIS = 65536
# Part of every cache key: change it whenever a builder's tree changes.
BVH_BUILDER_VERSION = b"tpu_raytracer_torch-bvh-v1"


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_raytracer_torch", "bvh")


def default_presplit(num_tris: int) -> float:
    """The split budget factor a mesh of ``num_tris`` triangles gets when
    the caller names none."""
    return PRESPLIT_FACTOR if num_tris > PRESPLIT_ABOVE_TRIS else 0.0


def _normalize_host(v: np.ndarray, exact: bool) -> np.ndarray:
    sq = np.sum(v * v, axis=-1, keepdims=True).astype(np.float32)
    inv = 1.0 / np.sqrt(sq) if exact else q_rsqrt(torch.from_numpy(sq)).numpy()
    return (v * inv).astype(np.float32)


def _build_tree(v0, v1, v2, max_depth, builder, presplit, presplit_gate) -> BVHArrays:
    sweep = builder != "native"
    kw = dict(max_depth=max_depth, min_leaf_size=MIN_LEAF_SIZE)
    if presplit > 0:
        from ..accel.presplit import presplit_refs

        refs = presplit_refs(v0, v1, v2, budget_factor=presplit, gate_mult=presplit_gate)
        if refs is not None:  # None: nothing to split, the normal build
            return build_bvh(v0, v1, v2, mode="sweep" if sweep else "reference", refs=refs,
                             **kw)
    if not sweep:
        return build_bvh(v0, v1, v2, mode="reference", **kw)
    if builder != "numpy" and len(v0) >= _NATIVE_MIN_TRIS:
        return native.build_bvh_native(v0, v1, v2, **kw)
    return build_bvh(v0, v1, v2, mode="sweep", **kw)


def build_mesh_bvh(v0, v1, v2, max_depth: int = MAX_DEPTH, builder: str = "auto",
                   presplit: float | None = None, presplit_gate: float = PRESPLIT_GATE,
                   opt_rounds: int = 0, cache_dir=None) -> BVHArrays:
    """The BVH of a mesh under ``from_triangles``' build options, from the
    disk cache where it holds the tree; the set-up span ``setup.bvh``
    (``utils/profiling.py``), its info ``cache_hit``, ``opt_rounds``,
    ``triangles`` and ``sah`` (``sah_cost`` of the tree returned), with
    ``setup.optimize`` inside it where a build runs the optimizer."""
    with setup("bvh") as span:
        bvh, hit = _cached_tree(v0, v1, v2, max_depth, builder, presplit, presplit_gate,
                                opt_rounds, cache_dir)
        span.info = {"cache_hit": hit, "opt_rounds": opt_rounds, "triangles": len(v0),
                     "sah": sah_cost(bvh)}
        return bvh


def _cached_tree(v0, v1, v2, max_depth, builder, presplit, presplit_gate, opt_rounds,
                 cache_dir) -> tuple[BVHArrays, bool]:
    """``build_mesh_bvh``'s tree, and whether it came from the cache."""
    if builder not in BUILDERS:
        raise ValueError(f"unknown builder {builder!r}; one of {BUILDERS}")
    num = len(v0)
    presplit = default_presplit(num) if presplit is None else float(presplit)

    def build():
        bvh = _build_tree(v0, v1, v2, max_depth, builder, presplit, presplit_gate)
        if opt_rounds > 0:
            from ..accel.optimize import optimize_bvh

            with setup("optimize") as opt:
                opt.info = {"rounds": opt_rounds}
                bvh = optimize_bvh(bvh, rounds=opt_rounds, max_depth=max_depth,
                                   report=opt.info)
        return bvh

    if cache_dir is False or num < CACHE_MIN_TRIS:
        return build(), False
    h = hashlib.sha256(BVH_BUILDER_VERSION)
    h.update(b"sweep" if builder != "native" else b"reference")
    h.update(b"opt%d" % opt_rounds)
    h.update(b"presplit%r-%r" % (presplit, float(presplit_gate)) if presplit > 0 else b"")
    h.update(np.int64([max_depth, MIN_LEAF_SIZE]).tobytes())
    for a in (v0, v1, v2):
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    fp = os.path.join(cache_dir or default_cache_dir(), f"bvh_{h.hexdigest()[:24]}.npz")
    if os.path.exists(fp):
        try:
            with np.load(fp) as data:
                bvh = BVHArrays(**{f.name: data[f.name]
                                   for f in dataclasses.fields(BVHArrays)})
            return bvh, True
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile, zlib.error):
            os.unlink(fp)  # a corrupt entry: build again and replace it
    bvh = build()
    os.makedirs(os.path.dirname(fp), exist_ok=True)
    # written whole to a temporary file, then renamed: a reader never sees
    # a partial entry, and concurrent writers do not interleave (the .npz
    # suffix stays, or np.savez would append one)
    tmp = fp[:-4] + f".tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **dataclasses.asdict(bvh))
        os.replace(tmp, fp)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return bvh, False


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
    def from_triangles(cls, v0, v1, v2, normal=None, uv0=None, uv1=None, uv2=None, *,
                       max_depth: int = MAX_DEPTH, exact_normals: bool = True,
                       builder: str = "auto", presplit: float | None = None,
                       presplit_gate: float = PRESPLIT_GATE, opt_rounds: int = 0,
                       cache_dir=None, vn0=None, vn1=None, vn2=None,
                       vn_mask=None) -> "MeshPrimitive":
        """Build from raw triangle arrays; face normals default to the
        normalized winding cross product. Vertex normals, where given,
        are permuted with the triangles. The build options are the
        module docstring's."""
        v0 = np.asarray(v0, np.float32).reshape(-1, 3)
        v1 = np.asarray(v1, np.float32).reshape(-1, 3)
        v2 = np.asarray(v2, np.float32).reshape(-1, 3)
        num = len(v0)
        if normal is None:
            normal = _normalize_host(np.cross(v1 - v0, v2 - v0), exact_normals)
        else:
            normal = np.asarray(normal, np.float32).reshape(-1, 3)
        zeros_uv = np.zeros((num, 2), np.float32)
        uv0 = zeros_uv if uv0 is None else np.asarray(uv0, np.float32).reshape(-1, 2)
        uv1 = zeros_uv if uv1 is None else np.asarray(uv1, np.float32).reshape(-1, 2)
        uv2 = zeros_uv if uv2 is None else np.asarray(uv2, np.float32).reshape(-1, 2)

        bvh = build_mesh_bvh(v0, v1, v2, max_depth=max_depth, builder=builder,
                             presplit=presplit, presplit_gate=presplit_gate,
                             opt_rounds=opt_rounds, cache_dir=cache_dir)
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

    def print_stats(self) -> None:
        """BVH diagnostics (the reference's print_stats, BVHTree.hpp:117-172)."""
        s = self.bvh.stats()
        print("BVH Stats:")
        print(f"Number of nodes: {s['num_nodes']}")
        print(f"Max triangles per node: {s['max_triangles_per_leaf']}")
        print(f"Min triangles per node: {s['min_triangles_per_leaf']}")
        print(f"Max depth: {s['max_depth']}")
        print(f"Number of leaves: {s['num_leaves']}")
        print(f"Average triangles per leaf: {s['avg_triangles_per_leaf']}")
