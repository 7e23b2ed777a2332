"""ctypes binding to the native OBJ parser (``scene/csrc/obj_loader.cpp``).

The port's counterpart of ``tpu_raytracer/scene/native_obj.py``. The
library is built with g++ at first use by ``kernels/build.py``
(``build_obj_parser``) into the gitignored ``kernels/_build/``, from the
source in this package; nothing prebuilt is loaded. Its results are bit
for bit those of the numpy parser (``objloader._parse_obj_py``), so the
two are interchangeable; the native one serves large files, where the
numpy parser's per-token work dominates the load. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..kernels.build import build_obj_parser

        lib = ctypes.CDLL(str(build_obj_parser()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.trt_obj_parse.restype = ctypes.c_void_p
        lib.trt_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.trt_obj_counts.restype = None
        lib.trt_obj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.trt_obj_fill.restype = ctypes.c_int32
        lib.trt_obj_fill.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, f32p, f32p, f32p, u8p]
        lib.trt_obj_free.restype = None
        lib.trt_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_obj_native(text: str):
    """Parse OBJ source with the C++ parser; the returns of
    ``objloader.parse_obj``. Raises ValueError on malformed input (where
    the numpy parser raises)."""
    lib = _load()
    raw = text.encode("utf-8", errors="replace")
    handle = lib.trt_obj_parse(raw, len(raw))
    if not handle:
        raise ValueError("malformed OBJ input")
    try:
        n = ctypes.c_int64()
        lib.trt_obj_counts(handle, ctypes.byref(n))
        num = int(n.value)
        v0, v1, v2 = (np.empty((num, 3), np.float32) for _ in range(3))
        uv0, uv1, uv2 = (np.empty((num, 2), np.float32) for _ in range(3))
        has_uv = np.empty(num, np.uint8)
        if num and lib.trt_obj_fill(handle, v0, v1, v2, uv0, uv1, uv2, has_uv) != 0:
            raise ValueError("OBJ face index out of range")
    finally:
        lib.trt_obj_free(handle)
    return v0, v1, v2, uv0, uv1, uv2, has_uv.astype(bool)
