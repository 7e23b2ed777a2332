"""A/B timing of kernels K1 and K3 against an earlier build of their sources.

    python -m tpu_raytracer_torch.bench_walk --old DIR [--out FILE]

``DIR`` holds the ``kernels/csrc`` of an earlier version of the port,
e.g. that of commit 496c404, whose K1 and K3 walk with ``walk_tree<4>``
(``git archive 496c404 tpu_raytracer_torch/kernels/csrc | tar -x -C DIR
--strip-components=3``). Its ``wide_traverse.cu`` and
``tlas_traverse.cu`` are built like the current ones into a second
library and called through that version's C interface (no node records,
no short stack, no ray counter).

On each ray set — the flagship's primary and shadow rays (K1 nearest and
any hit), config 5's first bounce rays (K1) and config 4's primary,
reflection and shadow rays (K3) — it checks that every variant of the
current design gives the earlier kernel's output bit for bit (t, tri,
inst; the any-hit t), then times the kernels in turns: earlier, current,
the variants, current, earlier. A time is the best of 5 loops of CUDA
events around 20 back-to-back launches (the current kernels' counter
reset included), divided by 20. The variants: the short stack's ring at
4, 8 and 16 slots (at launch), and builds of the current sources with
one change each (``PATCHED``): one thread per ray over a grid of all
rays instead of persistent warps, the node record per axis (lane
4k + c) instead of per child, the triangle
test without its early exits or with only one of them (at a back face,
or at a t out of range), and the other minimum of resident blocks per
SM in ``__launch_bounds__`` (K1 at 8 instead of none, K3 at none instead
of 8, which caps registers at 64). Prints ptxas's report of each build, one line per ray set, and
writes all of it as JSON to ``--out``. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import tempfile

import torch

from .kernels import build, traversal
from .kernels.wide4 import SHORT_STACK
from .utils.device import card_line

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the interface of the 496c404 build: no wnode, short stack or counter
_OLD_ARGS = {
    "wt_launch": [_I] + [_P] * 5 + [_I] + [_P, _I, _P, _I64, _I, _P, _P, _P, _P],
    "tlas_launch": [_P] * 5 + [_I] + [_P] * 3 + [_P, _I, _P, _I64, _I, _P, _P, _P, _P],
}
SOURCES = ("wide_traverse.cu", "tlas_traverse.cu")
STACKS = (4, 8, 16)
LOOPS, CALLS = 5, 20


def _lib(name: str, src_dir: pathlib.Path, argtypes: dict) -> tuple[ctypes.CDLL, pathlib.Path]:
    path = build._build(name, build.find_nvcc(), build.NVCC_FLAGS, SOURCES, src_dir=src_dir,
                        link_flags=build.NVCC_LINK_FLAGS)
    lib = ctypes.CDLL(str(path))
    for entry, types in argtypes.items():
        getattr(lib, entry).argtypes = types
        getattr(lib, entry).restype = ctypes.c_int
    return lib, path


def _per_axis(w) -> torch.Tensor:
    n = w.wcode.shape[0]
    rec = torch.zeros_like(w.wnode)
    rec[:, :24] = w.wbox[:, :24].reshape(n, 4, 6).transpose(1, 2).reshape(n, 24)
    rec[:, 24:28] = w.wcode.view(torch.float32)
    return rec.contiguous()


# for_each_ray as one ray per thread of the grid
_GRID_LOOP = """  {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r < num_rays) trace(r);
    return;
  }
  const unsigned lane = threadIdx.x & 31u;
"""
# test_tri4's early exits, and its last test with one of them folded in
_FACE_EXIT = "  if (!(denom <= -kParallelEps)) return false;\n"
_T_EXIT = ("  if (!((t >= 0.0f) && (t < best->t || (t == best->t && inst < best->inst)))) "
           "return false;\n")
_UV_EXIT = "if (!((u >= kEdgeLo) && (v >= kEdgeLo) && (u + v <= kEdgeHi))) return false;"
_UV_FACE_EXIT = ("if (!((u >= kEdgeLo) && (v >= kEdgeLo) && (u + v <= kEdgeHi) && "
                 "(denom <= -kParallelEps))) return false;")
_UV_T_EXIT = ("if (!((u >= kEdgeLo) && (v >= kEdgeLo) && (u + v <= kEdgeHi) && (t >= 0.0f) && "
              "(t < best->t || (t == best->t && inst < best->inst)))) return false;")
# name: ([(file, text, replacement)], node records of the build or None)
PATCHED = {
    "grid": ([("walk4.cuh", "  const unsigned lane = threadIdx.x & 31u;\n", _GRID_LOOP),
              ("walk4_launch.cuh", "int64_t blocks = static_cast<int64_t>(sms) * per_sm;",
               "int64_t blocks = grid;")], None),
    "per_axis": ([("walk4.cuh", "box_lane(int c, int k) { return 6 * c + k; }",
                   "box_lane(int c, int k) { return 4 * k + c; }")], _per_axis),
    "no_early_exit": ([("walk4.cuh", "if (test_tri4(r, o, d, k,", "if (test_tri(r, o, d, k,")],
                      None),
    "back_face_exit_only": ([("walk4.cuh", _T_EXIT, ""), ("walk4.cuh", _UV_EXIT, _UV_T_EXIT)],
                            None),
    "t_exit_only": ([("walk4.cuh", _FACE_EXIT, ""), ("walk4.cuh", _UV_EXIT, _UV_FACE_EXIT)],
                    None),
    "k1_min_blocks8": ([("walk4_launch.cuh", "kK1MinBlocks = 1;", "kK1MinBlocks = 8;")], None),
    "k3_min_blocks1": ([("walk4_launch.cuh", "kK3MinBlocks = 8;", "kK3MinBlocks = 1;")], None),
}


def _patched_sources(tmp: pathlib.Path, name: str) -> pathlib.Path:
    src = tmp / name
    shutil.copytree(build.CSRC, src)
    for f, text, repl in PATCHED[name][0]:
        path = src / f
        code = path.read_text()
        if text not in code:
            raise RuntimeError(f"{f} has no {text!r} for variant {name}")
        path.write_text(code.replace(text, repl))
    return src


class Caster:
    """Raw launches of one library's K1 or K3 on one ray set, outputs kept."""

    def __init__(self, lib, old: bool, kernel: str, scene, origin, dirs, occlusion: bool,
                 short_stack: int = SHORT_STACK, wnode=None):
        w = scene.wide4
        dev = dirs.device
        self.keep = [traversal.instance_table(scene),
                     w.wroot[scene.inst_mesh.long()].to(torch.int32).contiguous(),
                     origin.contiguous(), dirs.contiguous(),
                     w.wnode if wnode is None else wnode]
        inst_tab, inst_root, o, d, rec = self.keep
        r = d.numel() // 3
        self.t = torch.empty(r, dtype=torch.float32, device=dev)
        self.tri = torch.empty(r, dtype=torch.int32, device=dev)
        self.inst = torch.empty(r, dtype=torch.int32, device=dev)
        self.counter = None if old else torch.zeros(1, dtype=torch.int64, device=dev)
        scene_args = [w.wcode.data_ptr(), w.wbox.data_ptr(), w.tri_rec.data_ptr(),
                      inst_tab.data_ptr(), inst_root.data_ptr(), scene.num_instances]
        if not old:
            scene_args.append(rec.data_ptr())
        tl = scene.tlas
        tlas_args = ([tl.code.data_ptr(), tl.box.data_ptr(), tl.inst_ids.data_ptr()]
                     if kernel == "K3" else [])
        ray_args = [o.data_ptr(), 0 if o.dim() == 1 else 3, d.data_ptr(), r, int(occlusion),
                    self.t.data_ptr(), self.tri.data_ptr(), self.inst.data_ptr()]
        tail = [] if old else [short_stack, self.counter.data_ptr()]
        head = [4] if kernel == "K1" else []
        self.fn = getattr(lib, "wt_launch" if kernel == "K1" else "tlas_launch")
        self.args = head + scene_args + tlas_args + ray_args + tail

    def __call__(self):
        if self.counter is not None:
            self.counter.zero_()
        err = self.fn(*self.args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    def ms(self) -> float:
        best = float("inf")
        for _ in range(LOOPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                self()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / CALLS)
        return best


def ray_sets(dev):
    """{name: (kernel, scene, origin, dirs, occlusion)} of the measured rays."""
    from .app.scenes import scene_bunny, scene_colonnade, scene_instances
    from .core.vecmath import normalize
    from .render import generate_rays, hit_attributes
    from .render.integrators import _cosine_sample, _reflect
    from .render.shade import DEFAULT_LIGHT_DIRECTION, SHADOW_EPS
    from .render.sorted_cast import park_dead_rays
    from .utils import prng

    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32, device=dev))

    def primary(scene, cam):
        p = cam.ray_params(dev)
        o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        return o, d, hit_attributes(scene, o, d, traversal.cast_rays(scene, o, d))

    def shadow(at):
        return park_dead_rays(at.location + ldir * SHADOW_EPS, ldir.expand(at.location.shape),
                              at.hit)

    flag, cam = scene_bunny(1920, 1088, device=dev)
    o1, d1, a1 = primary(flag, cam)
    col, ccam = scene_colonnade(512, 512, device=dev)
    o5, d5, a5 = primary(col, ccam)
    # config 5's first bounce rays, as chip_smoke.py makes them (2 samples)
    key = prng.split(prng.PRNGKey(0), 3)[0].to(dev)
    nd = _cosine_sample(key, a5.normal[None].expand((2,) + a5.normal.shape), True)
    bounce = park_dead_rays(a5.location[None] + nd * SHADOW_EPS, nd,
                            a5.hit[None].expand(nd.shape[:-1]))
    inst4, cam4 = scene_instances(1920, 1088, device=dev)
    o4, d4, a4 = primary(inst4, cam4)
    rd = normalize(_reflect(d4, a4.normal))
    refl = park_dead_rays(a4.location + rd * SHADOW_EPS, rd, a4.hit)
    return {
        "K1_flagship_primary": ("K1", flag, o1, d1, False),
        "K1_flagship_shadow": ("K1", flag, *shadow(a1), True),
        "K1_config5_bounce": ("K1", col, *bounce, False),
        "K3_config4_primary": ("K3", inst4, o4, d4, False),
        "K3_config4_reflection": ("K3", inst4, *refl, False),
        "K3_config4_shadow": ("K3", inst4, *shadow(a4), True),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="kernels/csrc of the earlier version")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="JSON results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_walk needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    new_lib = build.load("cuda")
    old_lib, old_path = _lib("walk_old", args.old.resolve(), _OLD_ARGS)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench_walk-", dir=build.BUILD_ROOT))
    new_args = {k: build._ENTRY_ARGS["cuda"][k] for k in ("wt_launch", "tlas_launch")}
    patched = {v: _lib(f"walk_{v}", _patched_sources(tmp, v), new_args) for v in PATCHED}
    ptxas = {"old": build.ptxas_report(old_path), "new": build.ptxas_report(build.build_cuda()),
             **{v: build.ptxas_report(path) for v, (_, path) in patched.items()}}
    for k, v in ptxas.items():
        print(f"[ptxas] build={k} " + json.dumps(
            {n: r for n, r in v.items() if "wide" in n or "tlas" in n}), flush=True)
    for kernel, occ in (("K1", False), ("K1", True), ("K3", False), ("K3", True)):
        print(f"[shape] kernel={kernel} occlusion={occ} " + json.dumps(
            traversal.launch_shape(kernel, occ, 1920 * 1088)), flush=True)

    results = {"card": card, "ptxas": ptxas, "sets": {}}
    for name, (kernel, scene, o, d, occ) in ray_sets(dev).items():
        variants = {"old": Caster(old_lib, True, kernel, scene, o, d, occ)}
        for s in STACKS:
            variants[f"S{s}"] = Caster(new_lib, False, kernel, scene, o, d, occ, s)
        for v, (lib, _) in patched.items():
            records = PATCHED[v][1]
            variants[v] = Caster(lib, False, kernel, scene, o, d, occ,
                                 wnode=None if records is None else records(scene.wide4))
        default = f"S{SHORT_STACK}"
        ref = variants["old"]
        ref()
        diffs = {}
        for v, c in variants.items():
            c()
            torch.cuda.synchronize()
            diffs[v] = int((c.t.view(torch.int32) != ref.t.view(torch.int32)).sum())
            if not occ:
                diffs[v] += int((c.tri != ref.tri).sum() + (c.inst != ref.inst).sum())
        order = ["old", default] + [v for v in variants if v not in ("old", default)] + [
            default, "old"]
        times = {}
        for v in order:
            times.setdefault(v, []).append(variants[v].ms())
        line = {"rays": ref.t.numel(), "kernel": kernel, "any_hit": occ,
                "diffs_vs_old": diffs, "ms": times}
        results["sets"][name] = line
        print(f"[ab] set={name} " + json.dumps(line), flush=True)
        if any(diffs.values()):
            raise SystemExit(f"bench_walk FAILED: a variant differs from the old kernel on {name}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
