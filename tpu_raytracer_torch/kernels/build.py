"""Build and load the hand-written kernels from ``kernels/csrc``, the
native BVH builder from ``accel/csrc`` and the native OBJ parser from
``scene/csrc``.

The CUDA sources of K1/K2, K3, K4/K5, K6, K6's plan, the frame stages
S1-S6 (``frame.cu``) and the capture's node count (``capture.cu``, read by
``utils/profiling.py``) are compiled for ``sm_90a`` by one ``nvcc`` process
per source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). The host builds of the same headers (``g++``:
the traversal's in ``traverse_host.cpp``, S1-S6's in ``frame_host.cpp``)
serve the CPU tests, and the BVH builder
(``accel/csrc/bvh_builder.cpp``) and the OBJ parser
(``scene/csrc/obj_loader.cpp``) are ``g++`` builds too. Libraries go to
``kernels/_build/<name>-<hash>/``, keyed by a hash of the sources and
flags, built at first use; the directory is listed in ``.gitignore``.
Every failure raises: nothing falls back to another build.

Every call into the card's library goes through ``launch``, which fills in
the stream where the entry takes one, raises on a nonzero return and counts
the launch in ``LAUNCHES`` (the one registry of launch counts, by kernel
name); ``check_inputs`` checks the tensors a wrapper hands it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BVH_CSRC = pathlib.Path(__file__).resolve().parent.parent / "accel" / "csrc"
OBJ_CSRC = pathlib.Path(__file__).resolve().parent.parent / "scene" / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"

CUDA_SOURCES = ("wide_traverse.cu", "tlas_traverse.cu", "paged_traverse.cu", "paged_major.cu",
                "page_plan.cu", "frame.cu", "capture.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")
# the BVH builder's f32 arithmetic must match the numpy builder bit for
# bit: no FMA contraction (as the JAX package's native Makefile builds)
BVH_GXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (need the CUDA toolkit on PATH "
                           "or under /usr/local/cuda)")
    return nvcc


def _run(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands concurrently; returns their results in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    out = []
    for c, p in zip(cmds, procs):
        stdout, _ = p.communicate(timeout=600)
        out.append(subprocess.CompletedProcess(c, p.returncode, stdout, ""))
    return out


def _build(name: str, compiler: str, flags: tuple, sources: tuple,
           src_dir: pathlib.Path = CSRC, link_flags: tuple | None = None) -> pathlib.Path:
    """Compile ``src_dir/<sources>`` into ``lib<name>.so`` unless a build
    of the same sources and flags exists; returns the library path. With
    ``link_flags`` each source is compiled to an object by its own
    process, all at once, and the objects are linked with those flags;
    without, one command builds the library. Every command and the
    compiler's output are kept beside the library as ``build.log``."""
    h = hashlib.sha256(" ".join((compiler,) + flags + (link_flags or ())).encode())
    for f in sorted(src_dir.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"{name}-", dir=BUILD_ROOT))
    if link_flags is None:
        steps = [[[compiler, *flags, "-o", str(tmp / lib.name),
                   *(str(src_dir / s) for s in sources)]]]
    else:
        objs = [str(tmp / (s + ".o")) for s in sources]
        steps = [[[compiler, *flags, "-c", "-o", o, str(src_dir / s)]
                  for s, o in zip(sources, objs)],
                 [[compiler, *link_flags, "-o", str(tmp / lib.name), *objs]]]
    log = []
    for cmds in steps:
        for proc in _run(cmds):
            log.append(" ".join(proc.args) + "\n" + proc.stdout)
            if proc.returncode != 0:
                (tmp / "build.log").write_text("".join(log))
                raise RuntimeError(f"building lib{name}.so failed:\n{' '.join(proc.args)}\n"
                                   f"{proc.stdout}")
    (tmp / "build.log").write_text("".join(log))
    try:
        tmp.rename(out_dir)
    except OSError:  # a concurrent build finished first; use its library
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log(lib: pathlib.Path) -> str:
    return (lib.parent / "build.log").read_text()


KERNEL_NAMES = ("paged_major_kernel", "binary_traverse_kernel", "wide_traverse_kernel",
                "wide_traverse_carry_kernel", "tlas_traverse_carry_kernel",
                "tlas_traverse_kernel", "paged_wide_kernel", "paged_binary_kernel",
                "page_plan_init_kernel", "page_plan_tiles_kernel", "page_plan_order_kernel",
                "page_plan_lists_kernel", "frame_raygen_kernel", "frame_attrs_kernel",
                "frame_shade_kernel", "frame_sample_kernel", "frame_whitted_shade_kernel",
                "frame_path_bounce_kernel")


def ptxas_report(lib: pathlib.Path) -> dict[str, dict[str, int]]:
    """ptxas's ``-v`` report of each kernel in ``lib``'s build log, keyed
    ``name<template argument>`` (``wide_traverse_kernel<1>`` is K1's
    any-hit kernel): registers, stack frame, spill stores and loads, and
    static shared memory, in bytes."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for ln in build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = next((k for k in KERNEL_NAMES if k in m.group(1)), m.group(1))
            arg = re.search(r"IL[bi](\d+)E", m.group(1))
            cur = out.setdefault(name + (f"<{arg.group(1)}>" if arg else ""), {})
            continue
        if cur is None:
            continue
        for key, pat in (("stack_frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
        if "Used" in ln and "registers" in ln:
            cur.setdefault("smem", 0)
            cur = None
    return out


def build_cuda() -> pathlib.Path:
    """The kernels K1/K2, K3, K4/K5, K6, K6's plan and S1-S6 for sm_90a: one nvcc
    per source, started together, linked into ``libtraverse.so``."""
    return _build("traverse", find_nvcc(), NVCC_FLAGS, CUDA_SOURCES,
                  link_flags=NVCC_LINK_FLAGS)


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    return gxx


def build_host(short_stack: int) -> pathlib.Path:
    """g++ build of the kernels' traversal headers for the CPU tests, with
    ``short_stack`` ring slots in the short stack of K1-K6."""
    return _build("traverse_host", _gxx(), GXX_FLAGS + (f"-DWT_HOST_SHORT_STACK={short_stack}",),
                  ("traverse_host.cpp",))


def build_frame_host() -> pathlib.Path:
    """g++ build of the frame stages' per-ray math (``frame.cuh``) for the
    CPU tests."""
    return _build("frame_host", _gxx(), GXX_FLAGS, ("frame_host.cpp",))


def build_bvh_builder() -> pathlib.Path:
    """g++ build of the native BVH builder (``accel/csrc``)."""
    return _build("bvh_builder", _gxx(), BVH_GXX_FLAGS, ("bvh_builder.cpp",),
                  src_dir=BVH_CSRC)


def build_obj_parser() -> pathlib.Path:
    """g++ build of the native OBJ parser (``scene/csrc``)."""
    return _build("obj_parser", _gxx(), BVH_GXX_FLAGS, ("obj_loader.cpp",), src_dir=OBJ_CSRC)


class _Stream(ctypes.c_void_p):
    """The type of a CUDA stream argument, which ``launch`` fills in."""


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# node records, tri_rec, inst_tab, inst_root, num_instances
_SCENE_ARGS = [_P, _P, _P, _P, _I]
# origin, origin_stride, dirs, num_rays, occlusion, t_out, tri_out, inst_out,
# and the carried u_out, v_out, n_out (null: not carried)
_RAY_ARGS = [_P, _I, _P, _I64, _I, _P, _P, _P, _P, _P, _P]
# tlas code, box, inst_ids
_TLAS_ARGS = [_P, _P, _P]
# arity, page node records, page_node_base, page_tri0, tri_rec, inst_tab,
# num_instances
_PAGE_ARGS = [_I, _P, _P, _P, _P, _P, _I]
# top_code, top_box, inst_top_root
_TOP_ARGS = [_P, _P, _P]
# item_pid, item_iid, tile_start, tile_item, num_tiles
_PLAN_ARGS = [_P, _P, _P, _P, _I]
# K6's plan: origin, origin_stride, dirs, num_rays, inst_tab, inst_mesh,
# num_instances, node_min, node_max, page_node0, num_pages, mesh_root,
# num_meshes, wanted, tile_count, key, item_pid, item_iid, tile_start,
# tile_item
_PLAN_IO_ARGS = [_P, _I, _P, _I64, _P, _P, _I, _P, _P, _P, _I, _P, _I] + [_P] * 7
# origin, origin_stride, dirs, num_rays, t_out, tri_out, inst_out
_NEAREST_RAY_ARGS = [_P, _I, _P, _I64, _P, _P, _P]
# short_stack, num_rays, out[4]
_SHAPE_ARGS = [_I, _I64, _P]
# short_stack, counter
_WALK_ARGS = [_I, _P]
# S1: width, height, K_inv, D, inv_pose, exact, dirs
_RAYGEN_ARGS = [_I, _I, _P, _P, _P, _I, _P]
# S2: tri_v0, tri_v1, tri_v2, tri_normal, tri_uv0, tri_uv1, tri_uv2, tri_vnorm,
# tri_mat, inst_pose, inst_inv_pose, inst_scale, inst_inv_scale, inst_material,
# num_instances; origin, origin_stride, dirs, num_rays, t, tri, inst, u, v, n;
# exact, normal_mode; hit, location, normal, uv, material, inst outputs
_ATTRS_ARGS = [_P] * 14 + [_I] + [_P, _I, _P, _I64] + [_P] * 6 + [_I, _I] + [_P] * 6
# S3: mat_albedo, mat_tex_start, mat_tex_w, mat_tex_h, mat_tex_mip_start,
# num_levels, tex_atlas, atlas_size, textured; sky_tex_start, sky_tex_w,
# sky_tex_h, has_sky; hit, normal, uv, material, inst, location, dirs, lit,
# point_lights, point_occ_t, num_rays; mode, has_light, light xyz, exact,
# specular, shininess, filter, height, width, num_point_lights,
# point_shadows; out
_SHADE_ARGS = ([_P] * 5 + [_I] + [_P, _I64, _I] + [_P] * 3 + [_I] + [_P] * 10 + [_I64]
               + [_I, _I, _F, _F, _F, _I, _F, _F, _I, _I, _I, _I, _I] + [_P])
_U = ctypes.c_uint32
# S4: key, chain_len, chain words w0-w3, lobe_word; normal, inner, its
# strides (outer, inner, component), num_rays; exact; dirs, lobe outputs
_SAMPLE_ARGS = [_P, _I] + [_U] * 5 + [_P] + [_I64] * 5 + [_I, _P, _P]
# S5: S3's material and sky tables (mat_albedo ... has_sky);
# mat_reflectivity, mat_illumination; dirs, hit, location, normal, uv,
# material, illum, num_rays; filter, exact, first, last; radiance,
# throughput, active, origin and dirs outputs
_WHITTED_ARGS = _SHADE_ARGS[:13] + [_P] * 9 + [_I64] + [_I] * 4 + [_P] * 5
# S6: S3's material and sky tables (mat_albedo ... has_sky);
# mat_reflectivity, mat_illumination, mat_roughness; dirs, hit, location,
# normal, uv, material, period; t, d_diff, lobe, illum, num_rays; filter,
# exact, first, tail; sky_strength, light_scale; radiance, throughput,
# active, origin and dirs outputs
_PATH_ARGS = (_SHADE_ARGS[:13] + [_P] * 9 + [_I64] + [_P] * 4 + [_I64] + [_I] * 4 + [_F] * 2
              + [_P] * 5)
_ENTRY_ARGS = {
    # ... + stream (wt_launch takes t_max after the rays); the shapes take none
    "cuda": {"wt_launch": [_I] + _SCENE_ARGS + _RAY_ARGS + [_F] + _WALK_ARGS + [_Stream],
             "tlas_launch": _SCENE_ARGS + _TLAS_ARGS + _RAY_ARGS + _WALK_ARGS + [_Stream],
             "wt_launch_shape": [_I, _I] + _SHAPE_ARGS,  # arity, occlusion
             "tlas_launch_shape": [_I] + _SHAPE_ARGS,  # occlusion
             "paged_launch_shape": [_I] + _SHAPE_ARGS,  # arity
             "paged_major_launch_shape": _SHAPE_ARGS,
             "paged_launch": _PAGE_ARGS + _TOP_ARGS + _NEAREST_RAY_ARGS + _WALK_ARGS
             + [_Stream],
             "paged_major_launch": _PAGE_ARGS + _PLAN_ARGS + _NEAREST_RAY_ARGS + _WALK_ARGS
             + [_Stream],
             "page_plan_launch": _PLAN_IO_ARGS + [_Stream],
             "frame_raygen_launch": _RAYGEN_ARGS + [_Stream],
             "frame_attrs_launch": _ATTRS_ARGS + [_Stream],
             "frame_shade_launch": _SHADE_ARGS + [_Stream],
             "frame_sample_launch": _SAMPLE_ARGS + [_Stream],
             "frame_whitted_shade_launch": _WHITTED_ARGS + [_Stream],
             "frame_path_bounce_launch": _PATH_ARGS + [_Stream],
             # stream, int64 out: the capture's kernel, memcpy and memset nodes
             "capture_device_ops": [_Stream, _P]},
    # ... + spills (one i64 out; wt_trace_host takes t_max before it)
    "host": {"wt_trace_host": [_I] + _SCENE_ARGS + _RAY_ARGS + [_F, _P],
             "tlas_trace_host": _SCENE_ARGS + _TLAS_ARGS + _RAY_ARGS + [_P],
             "wt_sort_host": [_I, _P, _I64, _P],
             "wt_host_short_stack": [],
             "paged_trace_host": _PAGE_ARGS + _TOP_ARGS + _NEAREST_RAY_ARGS + [_P],
             "paged_major_trace_host": _PAGE_ARGS + _PLAN_ARGS + _NEAREST_RAY_ARGS + [_P],
             "page_plan_host": _PLAN_IO_ARGS},
    "frame_host": {"frame_raygen_host": _RAYGEN_ARGS, "frame_attrs_host": _ATTRS_ARGS,
                   "frame_shade_host": _SHADE_ARGS, "frame_sample_host": _SAMPLE_ARGS,
                   "frame_whitted_shade_host": _WHITTED_ARGS,
                   "frame_path_bounce_host": _PATH_ARGS},
}

_loaded: dict[tuple, ctypes.CDLL] = {}


def load(kind: str, short_stack: int | None = None) -> ctypes.CDLL:
    """Build (at first use) and load the ``cuda``, ``host`` or
    ``frame_host`` library, with every entry point's argument types
    declared. The host build of the traversal takes the short stack's ring
    slots (``short_stack``, default ``wide4.SHORT_STACK``) at compile
    time; the card's at launch."""
    from .wide4 import SHORT_STACK

    if kind not in _ENTRY_ARGS:
        raise ValueError(f"unknown kernel library {kind!r}")
    key = (kind, short_stack or SHORT_STACK) if kind == "host" else (kind,)
    if key not in _loaded:
        from ..utils.profiling import setup

        with setup("library") as span:
            span.info = {"kind": kind}
            path = {"cuda": build_cuda, "frame_host": build_frame_host}.get(kind)
            lib = ctypes.CDLL(str(path() if path is not None else build_host(key[1])))
        for entry, argtypes in _ENTRY_ARGS[kind].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[key] = lib
    return _loaded[key]


# Launches of each kernel since the counts were last reset: K1-K6 and S1-S6
# by the names of the kernel tables (``kernels/__init__.py``), K1_carry and
# K3_carry the launches of K1's and K3's carrying kernels, K1_bounded K1's
# launches bounded by a t_max below BIG, K6_plan the launches of K6's plan
# (its four kernels). Plain versions and host builds count nothing.
LAUNCHES = dict.fromkeys(("K1", "K1_carry", "K1_bounded", "K2", "K3", "K3_carry", "K4", "K5",
                          "K6", "K6_plan", "S1", "S2", "S3", "S4", "S5", "S6"), 0)


def reset_launches() -> None:
    """Zero every count of ``LAUNCHES``."""
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def launch(entry: str, *args, device=None, stream=None, count: tuple = ()) -> None:
    """Call ``entry`` of the ``cuda`` library with ``args``, the stream
    filled in where its interface takes one (``stream``, else the current
    stream of ``device``), then count one launch of each kernel named in
    ``count``. Raises ``RuntimeError`` naming the entry and the CUDA error
    on a nonzero return."""
    fn = getattr(load("cuda"), entry)
    if _Stream in fn.argtypes:
        at = fn.argtypes.index(_Stream)
        handle = (torch.cuda.current_stream(device) if stream is None else stream).cuda_stream
        args = args[:at] + (handle,) + args[at:]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")
    for name in count:
        LAUNCHES[name] += 1


def check_inputs(device, *tensors, aligned: tuple = ()) -> None:
    """Raise a ``ValueError`` naming the first of ``tensors``, each
    ``(name, tensor, dtype)``, that is not a contiguous tensor of its dtype
    on ``device``, or, where its name is in ``aligned``, does not start on
    a 16-byte boundary, as the kernels' 16-byte loads need."""
    for name, x, dtype in tensors:
        if x.dtype != dtype or not x.is_contiguous() or x.device != device:
            raise ValueError(f"{name} must be contiguous {dtype} on {device}, got "
                             f"{x.dtype} on {x.device} contiguous={x.is_contiguous()}")
        if name in aligned and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's 16-byte loads")
