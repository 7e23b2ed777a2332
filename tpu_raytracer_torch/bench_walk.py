"""A/B timing of kernels K1-K6 and of K6's plan against an earlier build
of their sources.

    python -m tpu_raytracer_torch.bench_walk --old DIR [--out FILE]

``DIR`` holds the ``kernels/csrc`` of an earlier version of the port,
e.g. that of commit b3ee60f, the last without the carry of K1 and K3
(``git archive b3ee60f tpu_raytracer_torch/kernels/csrc | tar -x -C DIR
--strip-components=3``). Its ``wide_traverse.cu``, ``tlas_traverse.cu``,
``paged_traverse.cu`` and ``paged_major.cu`` are built like the current
ones into a second library and called through that version's C
interface (``_OLD_ARGS``: K1-K3 without the carried outputs).

On each ray set it checks that every variant of the current design gives
the earlier kernel's output bit for bit (t, tri, inst; the any-hit t),
then times the kernels in turns: earlier, current, the variants,
current, earlier. A time is the best of 5 loops of CUDA events around 20
back-to-back launches (the counter reset included), divided by 20. The
sets: K1 and K2 on the flagship's primary and shadow (any hit) rays and
on config 5's first bounce rays; K1 on the textured cube's primary rays
at 1920x1088; K3 on config 4's primary, reflection and shadow rays; K4,
K5 (binary page tables) and K6 on the 1M-triangle colonnade's 1920x1088
rays, K6's in 16x16-pixel tile order with the card's plan made once.
The variants: the short stack's ring at 4, 8 and 16 slots (at launch),
the carrying kernels of K1 and K3 (``CARRY``: K1 carrying n on the
flagship's primary rays and u, v on the cube's, K3 carrying all three on
config 4's primary and reflection rays; their t, tri and inst checked
like the rest), and builds of the current sources with one change each
(``PATCHED``), timed on the sets of the kernels they change: one thread
per ray over a grid of all rays instead of persistent warps, the
triangle test without its early exits, the other minimum of resident
blocks per SM in ``__launch_bounds__`` for K3 and K4 (K3 without its 8,
which caps registers at 64; K4 with 8), K4's top tree on a stack of its
own in local memory instead of below the page walk's entries on the
short stack, and K6's other launch shape (persistent warps instead of
one block per tile). One more line times the plain plan
(``page_major_plan``, eager PyTorch with a host sync) against the card's
(``page_major_plan_cuda``) in turns on the colonnade's rays, after
checking that both give the same item order and tile lists. Prints
ptxas's report of each build, the launch shapes, one line per ray set,
and writes all of it as JSON to ``--out``. Fails without a CUDA card,
and if any variant differs from the earlier kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import tempfile

import torch

from .kernels import build, paged_major, traversal
from .kernels.wide4 import SHORT_STACK
from .utils.device import card_line

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the interface of the b3ee60f build: K1-K3 without the carried outputs
# (and K1 and K2 without the bound), K4-K6 as now
_OLD_SCENE = [_P, _P, _P, _P, _I]
_OLD_RAYS = [_P, _I, _P, _I64, _I, _P, _P, _P]
_OLD_ARGS = {
    "wt_launch": [_I] + _OLD_SCENE + _OLD_RAYS + [_I, _P, _P],
    "tlas_launch": _OLD_SCENE + [_P] * 3 + _OLD_RAYS + [_I, _P, _P],
    "paged_launch": build._ENTRY_ARGS["cuda"]["paged_launch"],
    "paged_major_launch": build._ENTRY_ARGS["cuda"]["paged_major_launch"],
}
SOURCES = ("wide_traverse.cu", "tlas_traverse.cu", "paged_traverse.cu", "paged_major.cu")
ENTRIES = tuple(_OLD_ARGS)
STACKS = (4, 8, 16)
LOOPS, CALLS = 5, 20
# the carrying kernels' variants, per ray set: name -> (u and v, n)
CARRY = {
    "K1_flagship_primary": {"carry_n": (False, True)},
    "K1_cube_primary": {"carry_uv": (True, False)},
    "K3_config4_primary": {"carry_uv_n": (True, True)},
    "K3_config4_reflection": {"carry_uv_n": (True, True)},
}

# for_each_ray as one ray per thread of the grid
_GRID_LOOP = """  {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r < num_rays) trace(r);
    return;
  }
  const unsigned lane = threadIdx.x & 31u;
"""
# K4's top tree on a 64-slot ring in local memory of its own (never
# spills: paged.py keeps the top depth under TOP_STACK = 64)
_TOP_LOCAL = """int32_t top_ring[64];
  ShortStack top_st(top_ring, 1, 63, nullptr);"""
# name: (kernels it changes, [(file, text, replacement)])
PATCHED = {
    "grid": (("K1", "K2", "K3", "K4", "K5"),
             [("walk.cuh", "  const unsigned lane = threadIdx.x & 31u;\n", _GRID_LOOP),
              ("walk_launch.cuh", "int64_t blocks = static_cast<int64_t>(sms) * per_sm;",
               "int64_t blocks = grid;")]),
    "no_early_exit": (("K1", "K2", "K3", "K4", "K5", "K6"),
                      [("walk.cuh",
                        "if (test_tri4<kCarry>(r, o, d, k, inst_val, kAnyHit, best, carry)",
                        "if (test_tri(r, o, d, k, inst_val, kAnyHit, best)")]),
    "k3_min_blocks1": (("K3",), [("walk_launch.cuh", "kK3MinBlocks = 8;", "kK3MinBlocks = 1;")]),
    "k4_min_blocks8": (("K4",), [("walk_launch.cuh", "kK4MinBlocks = 1;", "kK4MinBlocks = 8;")]),
    "k4_top_local": (("K4",), [("paged_traverse.cuh", "ShortStack& top_st = st;", _TOP_LOCAL)]),
    "k6_persistent": (("K6",), [
        ("paged_major.cu", "  const int64_t r = static_cast<int64_t>(blockIdx.x) * wt::kTileRays"
         " + threadIdx.x;\n  if (r < rays.num_rays) trace(r);",
         "  wt::for_each_ray(rays.num_rays, counter, trace);"),
        ("paged_major.cu", "  int shape[4];\n  const int err = tile_shape(",
         "  return wt::launch_walk(paged_major_kernel, num_rays, short_stack, counter, st, pg,"
         " plan, rays);\n  int shape[4];\n  const int err = tile_shape(")]),
}


def _lib(name: str, src_dir: pathlib.Path, argtypes: dict) -> tuple[ctypes.CDLL, pathlib.Path]:
    path = build._build(name, build.find_nvcc(), build.NVCC_FLAGS, SOURCES, src_dir=src_dir,
                        link_flags=build.NVCC_LINK_FLAGS)
    lib = ctypes.CDLL(str(path))
    for entry, types in argtypes.items():
        getattr(lib, entry).argtypes = types
        getattr(lib, entry).restype = ctypes.c_int
    return lib, path


def _patched_sources(tmp: pathlib.Path, name: str) -> pathlib.Path:
    src = tmp / name
    shutil.copytree(build.CSRC, src)
    for f, text, repl in PATCHED[name][1]:
        path = src / f
        code = path.read_text()
        if text not in code:
            raise RuntimeError(f"{f} has no {text!r} for variant {name}")
        path.write_text(code.replace(text, repl))
    return src


def best_ms(fn) -> float:
    """Best of LOOPS loops of CUDA events around CALLS calls of ``fn``,
    per call."""
    best = float("inf")
    for _ in range(LOOPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / CALLS)
    return best


class Caster:
    """Raw launches of one library's K1-K6 on one ray set, outputs kept.
    K6's rays come in tile order with the card plan's (item_pid,
    item_iid, tile_start, tile_item). ``carry`` = (u and v, n) launches
    K1's or K3's carrying kernel (the current build only)."""

    def __init__(self, lib, old: bool, kernel: str, scene, origin, dirs, occlusion: bool,
                 short_stack: int = SHORT_STACK, plan=None, carry=(False, False)):
        w = scene.wide4
        dev = dirs.device
        root = scene.binary.root if kernel == "K2" else w.wroot
        if kernel in ("K4", "K5"):
            root = scene.paged.top_root
        self.keep = [traversal.instance_table(scene),
                     root[scene.inst_mesh.long()].to(torch.int32).contiguous(),
                     origin.contiguous(), dirs.contiguous(), plan]
        inst_tab, inst_root, o, d, _ = self.keep
        r = d.numel() // 3
        self.t = torch.empty(r, dtype=torch.float32, device=dev)
        self.tri = torch.empty(r, dtype=torch.int32, device=dev)
        self.inst = torch.empty(r, dtype=torch.int32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        uv, n = carry
        self.carried = (torch.empty(r, device=dev) if uv else None,
                        torch.empty(r, device=dev) if uv else None,
                        torch.empty(r, 3, device=dev) if n else None)
        rays = [o.data_ptr(), 0 if o.dim() == 1 else 3, d.data_ptr(), r]
        outs = [self.t.data_ptr(), self.tri.data_ptr(), self.inst.data_ptr()]
        walk = [short_stack, self.counter.data_ptr()]
        if kernel in ("K4", "K5", "K6"):
            pg = scene.paged
            tail = [scene.tri_rec.data_ptr(), inst_tab.data_ptr(), scene.num_instances]
            head = [pg.arity, pg.node.data_ptr(), pg.node_base.data_ptr(),
                    pg.page_tri0.data_ptr(), *tail]
            if kernel == "K6":
                self.fn = lib.paged_major_launch
                plan_args = [x.data_ptr() for x in plan] + [plan[2].shape[0] - 1]
                self.args = head + plan_args + rays + outs + walk
                return
            top = [pg.top_code.data_ptr(), pg.top_box.data_ptr(), inst_root.data_ptr()]
            self.fn = lib.paged_launch
            self.args = head + top + rays + outs + walk
            return
        tree = scene.binary if kernel == "K2" else None
        node = w.wnode if tree is None else tree.node
        scene_args = [node.data_ptr(), w.tri_rec.data_ptr(), inst_tab.data_ptr(),
                      inst_root.data_ptr(), scene.num_instances]
        tl = scene.tlas
        tlas_args = ([tl.code.data_ptr(), tl.box.data_ptr(), tl.inst_ids.data_ptr()]
                     if kernel == "K3" else [])
        head = {"K1": [4], "K2": [2], "K3": []}[kernel]
        self.fn = lib.tlas_launch if kernel == "K3" else lib.wt_launch
        carried = [] if old else [None if x is None else x.data_ptr() for x in self.carried]
        # the current K1 and K2 take a bound after the rays: unbounded here
        bound = [traversal.BIG] if not old and kernel != "K3" else []
        self.args = (head + scene_args + tlas_args + rays + [int(occlusion)] + outs + carried
                     + bound + walk)

    def __call__(self):
        self.counter.zero_()
        err = self.fn(*self.args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    def ms(self) -> float:
        return best_ms(self)


def ray_sets(dev):
    """{name: (kernel, scene, origin, dirs, occlusion)} of the measured rays."""
    from .app.scenes import scene_bunny, scene_colonnade, scene_cube, scene_instances
    from .render import Camera
    from .core.vecmath import normalize
    from .render import generate_rays, hit_attributes
    from .render.integrators import _reflect, sample_cosine
    from .render.shade import DEFAULT_LIGHT_DIRECTION, SHADOW_EPS
    from .render.sorted_cast import park_dead_rays
    from .utils import prng

    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32, device=dev))

    def rays(cam):
        p = cam.ray_params(dev)
        return generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])

    def primary(scene, cam):
        o, d = rays(cam)
        return o, d, hit_attributes(scene, o, d, traversal.cast_rays(scene, o, d))

    def shadow(at):
        return park_dead_rays(at.location + ldir * SHADOW_EPS, ldir.expand(at.location.shape),
                              at.hit)

    flag, cam = scene_bunny(1920, 1088, device=dev)
    o1, d1, a1 = primary(flag, cam)
    cube, cube_cam = scene_cube(64, device=dev)
    oc, dc = rays(Camera.looking(1920, 1088, fov_deg=45.0, pose=cube_cam.pose))
    shadow1 = shadow(a1)
    col, ccam = scene_colonnade(512, 512, device=dev)
    o5, d5, a5 = primary(col, ccam)
    # config 5's first bounce rays, as chip_smoke.py makes them (2 samples)
    # (the draw of split(PRNGKey(0), 3)[0])
    nd = sample_cosine(prng.PRNGKey(0, device=dev), (0,),
                       a5.normal[None].expand((2,) + a5.normal.shape), True)
    bounce = park_dead_rays(a5.location[None] + nd * SHADOW_EPS, nd,
                            a5.hit[None].expand(nd.shape[:-1]))
    inst4, cam4 = scene_instances(1920, 1088, device=dev)
    o4, d4, a4 = primary(inst4, cam4)
    rd = normalize(_reflect(d4, a4.normal))
    refl = park_dead_rays(a4.location + rd * SHADOW_EPS, rd, a4.hit)
    big, bcam = scene_colonnade(1920, 1088, columns=18, segs=40, device=dev)
    ob, db = rays(bcam)
    wide = big.with_paging()
    _, ot, dt = paged_major._tile_rays(ob, db)
    return {
        "K1_flagship_primary": ("K1", flag, o1, d1, False),
        "K1_flagship_shadow": ("K1", flag, *shadow1, True),
        "K1_config5_bounce": ("K1", col, *bounce, False),
        "K1_cube_primary": ("K1", cube, oc, dc, False),
        "K3_config4_primary": ("K3", inst4, o4, d4, False),
        "K3_config4_reflection": ("K3", inst4, *refl, False),
        "K3_config4_shadow": ("K3", inst4, *shadow(a4), True),
        "K2_flagship_primary": ("K2", flag, o1, d1, False),
        "K2_flagship_shadow": ("K2", flag, *shadow1, True),
        "K2_config5_bounce": ("K2", col, *bounce, False),
        "K4_colonnade_primary": ("K4", wide, ob, db, False),
        "K5_colonnade_primary": ("K5", big.with_paging(wide=False), ob, db, False),
        "K6_colonnade_primary": ("K6", wide, ot, dt, False),
    }


def plan_line(scene, origin, dirs) -> dict:
    """The plain plan against the card's on rays in tile order: equal item
    order and tile lists, then their times in turns (plain, card, card,
    plain)."""
    pid, iid, mask = paged_major.page_major_plan(scene, origin, dirs)
    start, items = paged_major.tile_lists(mask)
    c_pid, c_iid, c_start, c_items = paged_major.page_major_plan_cuda(scene, origin, dirs)
    n = pid.shape[0]
    same = (torch.equal(c_pid[:n], pid) and torch.equal(c_iid[:n], iid)
            and torch.equal(c_start, start)
            and torch.equal(c_items[:items.shape[0]], items))
    eager = lambda: paged_major.page_major_plan(scene, origin, dirs)
    card = lambda: paged_major.page_major_plan_cuda(scene, origin, dirs)
    times = {}
    for name, fn in (("plain", eager), ("card", card), ("card", card), ("plain", eager)):
        times.setdefault(name, []).append(best_ms(fn))
    return {"rays": dirs.shape[0], "items_seen": n, "items": c_pid.shape[0],
            "tiles": start.shape[0] - 1, "list_entries": int(start[-1]), "same": same,
            "ms": times}


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
    new_args = {k: build._ENTRY_ARGS["cuda"][k] for k in ENTRIES}
    patched = {v: _lib(f"walk_{v}", _patched_sources(tmp, v), new_args) for v in PATCHED}
    ptxas = {"old": build.ptxas_report(old_path), "new": build.ptxas_report(build.build_cuda()),
             **{v: build.ptxas_report(path) for v, (_, path) in patched.items()}}
    for k, v in ptxas.items():
        print(f"[ptxas] build={k} " + json.dumps(v), flush=True)
    shapes = {}
    for kernel, occ in (("K1", False), ("K1", True), ("K2", False), ("K2", True), ("K3", False),
                        ("K3", True), ("K4", False), ("K5", False), ("K6", False)):
        shapes[f"{kernel}{'_any_hit' if occ else ''}"] = traversal.launch_shape(
            kernel, occ, 1920 * 1088)
    for kernel in ("K1", "K3"):
        shapes[f"{kernel}_carry"] = traversal.launch_shape(kernel, False, 1920 * 1088,
                                                           carry=True)
    print("[shape] rays=1920x1088 " + json.dumps(shapes), flush=True)

    results = {"card": card, "ptxas": ptxas, "shapes": shapes, "sets": {}}
    for name, (kernel, scene, o, d, occ) in ray_sets(dev).items():
        new_plan = None
        if kernel == "K6":
            new_plan = paged_major.page_major_plan_cuda(scene, o, d)
            results["plan"] = plan_line(scene, o, d)
            print("[plan] " + json.dumps(results["plan"]), flush=True)
            if not results["plan"]["same"]:
                raise SystemExit("bench_walk FAILED: the card's plan differs from the plain plan")
        variants = {"old": Caster(old_lib, True, kernel, scene, o, d, occ, plan=new_plan)}
        for s in STACKS:
            variants[f"S{s}"] = Caster(new_lib, False, kernel, scene, o, d, occ, s, new_plan)
        for v, fields in CARRY.get(name, {}).items():
            variants[v] = Caster(new_lib, False, kernel, scene, o, d, occ, carry=fields)
        for v, (lib, _) in patched.items():
            if kernel in PATCHED[v][0]:
                variants[v] = Caster(lib, False, kernel, scene, o, d, occ, plan=new_plan)
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
