"""ctypes binding to the native C++ BVH builder (``accel/csrc/bvh_builder.cpp``).

The port's counterpart of ``tpu_raytracer/accel/native.py``. The library
is built with g++ at first use by ``kernels/build.py``
(``build_bvh_builder``) into the gitignored ``kernels/_build/``, from
the source in this package; nothing prebuilt is loaded. It builds the
exact-SAH sweep tree only (the meshes' build), bit-identical to the
numpy builder's (``accel/bvh.py``, ``mode="sweep"``), so the two are
interchangeable; the native path exists for meshes of hundreds of
thousands of triangles, where the numpy builder's per-node Python work
takes minutes. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .bvh import BVHArrays

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..kernels.build import build_bvh_builder

        lib = ctypes.CDLL(str(build_bvh_builder()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.trt_build_bvh_sweep.restype = i32
        lib.trt_build_bvh_sweep.argtypes = [f32p, f32p, f32p, i32, i32, i32,
                                            f32p, f32p, i32p, i32p, i32p, i32p, i32p]
        _lib = lib
    return _lib


def build_bvh_native(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_depth: int = 48,
    min_leaf_size: int = 1,
) -> BVHArrays:
    """Build a BVH with the C++ builder: the exact-SAH sweep tree that
    ``accel/bvh.py``'s ``build_bvh`` builds with the same arguments."""
    lib = _load()
    v0 = np.ascontiguousarray(v0, np.float32).reshape(-1, 3)
    v1 = np.ascontiguousarray(v1, np.float32).reshape(-1, 3)
    v2 = np.ascontiguousarray(v2, np.float32).reshape(-1, 3)
    t = len(v0)
    cap = max(2 * t - 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    child_a = np.empty(cap, np.int32)
    child_b = np.empty(cap, np.int32)
    leaf_start = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    outs = (node_min.reshape(-1), node_max.reshape(-1), child_a, child_b, leaf_start,
            leaf_count, order)
    verts = (v0.reshape(-1), v1.reshape(-1), v2.reshape(-1))
    n = lib.trt_build_bvh_sweep(*verts, t, max_depth, min_leaf_size, *outs)
    return BVHArrays(
        node_min=node_min[:n].copy(),
        node_max=node_max[:n].copy(),
        child_a=child_a[:n].copy(),
        child_b=child_b[:n].copy(),
        leaf_start=leaf_start[:n].copy(),
        leaf_count=leaf_count[:n].copy(),
        order=order[:t].copy(),
    )
