"""Build and load the hand-written kernels from ``kernels/csrc``.

The CUDA sources of K1 and K3 are compiled with one ``nvcc`` command for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The host
build of the same traversal headers (``g++``) serves the CPU tests. Libraries go to
``kernels/_build/<name>-<hash>/``, keyed by a hash of the sources and
flags, built at first use; the directory is listed in ``.gitignore``.
Every failure raises: nothing falls back to another build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (need the CUDA toolkit on PATH "
                           "or under /usr/local/cuda)")
    return nvcc


def _build(name: str, compiler: str, flags: tuple, sources: tuple) -> pathlib.Path:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` unless a build of
    the same sources and flags exists; returns the library path. The
    compiler's output is kept beside the library as ``build.log``."""
    h = hashlib.sha256(" ".join((compiler,) + flags).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"{name}-", dir=BUILD_ROOT))
    cmd = [compiler, *flags, "-o", str(tmp / lib.name), *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    (tmp / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"building {' '.join(sources)} failed:\n{proc.stdout}{proc.stderr}")
    try:
        tmp.rename(out_dir)
    except OSError:  # a concurrent build finished first; use its library
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log(lib: pathlib.Path) -> str:
    return (lib.parent / "build.log").read_text()


def build_cuda() -> pathlib.Path:
    """One nvcc build of K1 (``csrc/wide_traverse.cu``) and K3
    (``csrc/tlas_traverse.cu``) for sm_90a."""
    return _build("traverse", find_nvcc(), NVCC_FLAGS,
                  ("wide_traverse.cu", "tlas_traverse.cu"))


def build_host() -> pathlib.Path:
    """g++ build of the K1 and K3 traversal headers for the CPU tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    return _build("traverse_host", gxx, GXX_FLAGS, ("traverse_host.cpp",))


_P = ctypes.c_void_p
_I = ctypes.c_int
# wcode, wbox, tri_rec, inst_tab, inst_root, num_instances
_SCENE_ARGS = [_P, _P, _P, _P, _P, _I]
# origin, origin_stride, dirs, num_rays, occlusion, t_out, tri_out, inst_out
_RAY_ARGS = [_P, _I, _P, ctypes.c_int64, _I, _P, _P, _P]
# tlas code, box, inst_ids
_TLAS_ARGS = [_P, _P, _P]
_ENTRY_ARGS = {
    "cuda": {"wt_launch": _SCENE_ARGS + _RAY_ARGS + [_P],  # + stream
             "tlas_launch": _SCENE_ARGS + _TLAS_ARGS + _RAY_ARGS + [_P]},
    "host": {"wt_trace_host": _SCENE_ARGS + _RAY_ARGS,
             "tlas_trace_host": _SCENE_ARGS + _TLAS_ARGS + _RAY_ARGS},
}

_loaded: dict[str, ctypes.CDLL] = {}


def load(kind: str) -> ctypes.CDLL:
    """Build (at first use) and load the ``cuda`` or ``host`` library,
    with every entry point's argument types declared."""
    if kind not in _loaded:
        if kind not in _ENTRY_ARGS:
            raise ValueError(f"unknown kernel library {kind!r}")
        lib = ctypes.CDLL(str(build_cuda() if kind == "cuda" else build_host()))
        for entry, argtypes in _ENTRY_ARGS[kind].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[kind] = lib
    return _loaded[kind]
