"""The big-scene record of the port (counterpart of the root
``bench_paged.py``): the ~1.04M-triangle colonnade through the paged
kernels, one JSON line per measurement.

    python -m tpu_raytracer_torch.bench_paged                  # 18x18 columns
    python -m tpu_raytracer_torch.bench_paged --columns 6      # ~115k triangles
    python -m tpu_raytracer_torch.bench_paged instanced        # the K6 part alone
    python -m tpu_raytracer_torch.bench_paged --device cpu --columns 2
    python -m tpu_raytracer_torch.bench_paged sweep | tee sweep.jsonl

Lines, in order (at 512x512, the root script's size):

  1. the colonnade's build: ``scene_tris``, ``bvh_nodes``, ``compile_s``;
  2. per page arity (4-wide pages for K4 and K6, binary for K5): the page
     tables' ``num_pages``, ``top_nodes``, ``page_table_s``;
  3. per arity, the paged cast (K4, K5) against ``cast_rays_brute`` on the
     root script's 192 sampled rays (``default_rng(0)``, the first 64 on
     the middle row, the next 64 on the middle column):
     ``paged_vs_brute_t_close`` (t within 1e-5 on every ray),
     ``tri_id_diffs_of_192``, and ``t_unexplained_of_192``: rays whose t
     is not within 1e-5 of the brute cast's for a reason other than box
     culling (the brute cast also finds hits up to EDGE_EPS outside a
     triangle and outside its leaf box, which a walk culls;
     ``traversal.unexplained_differences``);
  4. per arity, the paged frame's rate (``render_image_paged``, which
     goes through ``compiled_render_image``: on the card the warm frame
     captures a CUDA graph and the timed frames replay it);
  5. ``instanced_page_major``: two posed instances of the colonnade through
     K6, its rate on the full frame, and the items of K6's plan
     (``paged_major.page_major_plan_cuda``): ``pages_streamed_per_frame``,
     the (instance, page) items some tile sees, each swept once by the
     tiles that see it (``tile_items_per_frame`` counts those sweeps), of
     ``item_grid`` items; then 96 sampled rays against the brute cast.

Before those, ``route``: whether the scene needs paging
(``SceneTensors.needs_paging``) and so which kernel the ``cuda`` backend
casts it with; where K1 cannot address the scene, the line says why.

Every line carries ``card`` (the card's name and power limit; ``cpu`` on
the CPU, whose times are no device measurement). Frames are timed as the
root script times them: one warm frame, then the mean of 4, the card
synchronized at both ends. ``--columns`` replaces the root script's
``TRT_PAGED_COLUMNS``.

``sweep`` is the measurement behind the port's paging rule
(``kernels/traversal.py PAGING_ROWS``) and its paged route: colonnades
of ``SWEEP_COLUMNS`` (``segs=40``; 18, 22, 26, 36, 51 columns: 1.04M,
1.55M, 2.16M, 4.15M and 8.30M triangles before presplit, which is on
above 1,310,712) built and compiled as ``Scene.compile`` does by
default, at 1920x1088:

  * ``sweep_scene``: triangles, padded rows, whether the scene needs
    paging and the tables the compile attached, the host build in seconds
    with the BVH disk cache cold (a fresh directory) and then warm (the
    mesh and the compile apart), each kernel's table MB, and the page
    tables' build seconds;
  * ``sweep_cast``, per ray set (``primary``: the camera's rays;
    ``bounce``: one cosine-sampled bounce ray per pixel off the primary
    hits, dead rays parked, as config 5 makes them) and kernel (K1 where
    it can address the scene, else a line saying why; K4, K5 and K6):
    ``cast_ms``, CUDA events around one wrapper call (K6's with its plan),
    and ``kernel_ms`` (K6's ``plan_kernel_ms`` apart), ``torch.profiler``'s
    device time, each the median of 20 runs taken in turns (every kernel
    once per turn), with the 10th and 90th percentiles: the spread;
  * ``sweep_verdict`` per scene: each paged kernel's cast against K1's
    below the limit (a win needs the median gap to exceed the larger
    spread), and K6's casts (primary plus bounce) against K4's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from .app.scenes import scene_colonnade, scene_colonnade_pair
from .bench_all import Bench
from .kernels import paged_major
from .kernels.paged import cast_rays_paged_cuda
from .kernels.traversal import unexplained_differences
from .render import Hit, RenderConfig, generate_rays
from .render.pipeline import clear_compiled, render_image_paged
from .render.renderer import cast_rays_brute

# t of a sampled ray against the brute cast's (the root script's tolerance)
BRUTE_TOL = 1e-5
BRUTE_CHUNK = 16  # rays per brute cast: it is O(rays x triangles) in memory
SIZE = 512  # image width and height, as the root script fixes them
SWEEP_COLUMNS = (18, 22, 26, 36, 51)
SWEEP_SIZE = (1920, 1088)
SWEEP_RUNS = 20
SEGS = 40
CAMERA_POSE = [1.0, -2.0, 1.6, 0, 0, 0]  # scene_colonnade's camera


def line(run: Bench, **fields) -> None:
    print(json.dumps({**fields, "card": run.card}), flush=True)


def sampled(d: torch.Tensor, n: int, seed: int, axis_blocks: bool) -> torch.Tensor:
    """``n`` rays of the [H, W, 3] directions at ``default_rng(seed)``
    pixels; with ``axis_blocks`` the first 64 on the middle row and the
    next 64 on the middle column (degenerate axis-aligned rays)."""
    h, w = d.shape[:2]
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    if axis_blocks:
        ys[:64] = h // 2
        xs[64:128] = w // 2
    return d[torch.from_numpy(ys).to(d.device), torch.from_numpy(xs).to(d.device)].contiguous()


def brute(scene, o, sample_d) -> Hit:
    parts = [cast_rays_brute(scene, o, sample_d[c:c + BRUTE_CHUNK])
             for c in range(0, sample_d.shape[0], BRUTE_CHUNK)]
    return Hit(*(torch.cat([h[i] for h in parts]) for i in range(3)))


def against_brute(scene, o, sample_d, hit: Hit) -> dict:
    """The sampled hits against the brute cast: t within BRUTE_TOL on
    every ray, tri and inst differences, and the rays apart in t that no
    box culling explains."""
    b = brute(scene, o, sample_d)
    close = torch.isclose(hit.t, b.t, rtol=BRUTE_TOL, atol=BRUTE_TOL)
    far = ~close
    sub = lambda h: Hit(*(x[far] for x in h[:3]))
    unexplained = unexplained_differences(scene, o.expand(sample_d.shape)[far], sample_d[far],
                                          sub(hit), sub(b))
    return {"t_close": bool(close.all()), "tri": int((hit.tri != b.tri).sum()),
            "inst": int((hit.inst != b.inst).sum()), "unexplained": unexplained}


def route_line(run: Bench, scene) -> None:
    """Which kernel the ``cuda`` backend casts ``scene`` with, and where K1
    cannot address it, why."""
    from .accel.wide import LEAF_ROWS

    paged = scene.needs_paging()
    fields = {"route": "K4" if paged else ("K3" if scene.tlas is not None else "K1"),
              "needs_paging": paged, "rows": scene.num_triangles}
    if paged:
        fields["k1"] = (f"cannot address the scene: its {scene.num_triangles} triangle rows "
                        f"reach the leaf code's {LEAF_ROWS}; no resident tables are built")
    line(run, **fields)


def paged(run: Bench, columns: int, size: int) -> None:
    t0 = time.perf_counter()
    scene, cam = scene_colonnade(size, size, columns=columns, segs=40, device=run.device)
    run.sync()
    line(run, scene_tris=scene.num_triangles, bvh_nodes=int(scene.node_child_a.shape[0]),
         compile_s=time.perf_counter() - t0)
    route_line(run, scene)
    p = cam.ray_params(scene.device)
    args = (RenderConfig(cam.width, cam.height), p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = generate_rays(cam.width, cam.height, *args[1:])
    sample_d = sampled(d, 192, 0, axis_blocks=True)
    mtris = round(scene.num_triangles / 1e6, 2)
    for kernel, wide in (("K4", True), ("K5", False)):
        t0 = time.perf_counter()
        tables = scene.with_paging(wide=wide)
        run.sync()
        line(run, kernel=kernel, page_arity=tables.paged.arity,
             num_pages=tables.paged.num_pages, top_nodes=int(tables.paged.top_code.shape[0]),
             page_table_s=time.perf_counter() - t0)
        cmp = against_brute(scene, o, sample_d, cast_rays_paged_cuda(tables, o, sample_d))
        line(run, kernel=kernel, paged_vs_brute_t_close=cmp["t_close"],
             tri_id_diffs_of_192=cmp["tri"], t_unexplained_of_192=cmp["unexplained"])
        dt = run.timed(lambda: render_image_paged(args[0], tables, *args[1:]))
        line(run, metric=f"paged {kernel} {mtris}M-tri colonnade @{cam.width}x{cam.height}",
             fps=1 / dt, mrays_per_s=cam.width * cam.height / dt / 1e6)
        clear_compiled()  # the frame's entry holds the tables
        del tables
    del scene
    instanced_page_major(run, columns, size)


def instanced_page_major(run: Bench, columns: int, size: int) -> None:
    """Two instances of the colonnade (the second posed and scaled) through
    K6 (``scene_colonnade_pair``): the full frame's rate and plan items,
    then 96 sampled rays (``default_rng(1)``) against the brute cast."""
    scene, cam = scene_colonnade_pair(size, size, columns=columns, segs=40, device=run.device)
    scene = scene.with_paging()
    p = cam.ray_params(scene.device)
    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    _, o_t, d_t = paged_major._tile_rays(o, d)
    _, _, tile_start, tile_item = paged_major.page_major_plan_cuda(scene, o_t, d_t)
    pairs = int(tile_start[-1])
    streamed = int(torch.unique(tile_item[:pairs]).numel())
    dt = run.timed(lambda: paged_major.cast_rays_paged_major_cuda(scene, o, d).t)
    sample_d = sampled(d, 96, 1, axis_blocks=False)
    cmp = against_brute(scene, o, sample_d,
                        paged_major.cast_rays_paged_major_cuda(scene, o, sample_d))
    line(run, metric=(f"page-major 2-instance x {round(scene.num_triangles / 1e6, 2)}M-tri "
                      f"@{cam.width}x{cam.height}"),
         fps=1 / dt, mrays_per_s=cam.width * cam.height / dt / 1e6,
         pages_streamed_per_frame=streamed, tile_items_per_frame=pairs,
         item_grid=scene.num_instances * scene.paged.num_pages,
         sample_t_close_vs_brute=cmp["t_close"], inst_id_diffs_of_96=cmp["inst"],
         t_unexplained_of_96=cmp["unexplained"])


def _mb(*tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def scene_mb(scene) -> float:
    """Device MB of every tensor the scene holds, its tables included."""
    seen, total = set(), 0
    stack = [scene]
    while stack:
        obj = stack.pop()
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            if isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
            elif dataclasses.is_dataclass(x):
                stack.append(x)
    return total / 1e6


def build_colonnade(run: Bench, columns: int, cache_dir: str):
    """(compiled colonnade, mesh seconds, compile seconds): the mesh of
    ``scene_colonnade`` through the BVH disk cache in ``cache_dir``,
    compiled with the defaults."""
    from .scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

    t0 = time.perf_counter()
    mesh = MeshPrimitive.from_triangles(*procgen.colonnade(columns, columns, SEGS),
                                        cache_dir=cache_dir)
    t1 = time.perf_counter()
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    scene.add_mesh(mesh)
    scene.add_mesh_instance(MeshInstance(0, 0))
    compiled = scene.compile(run.device)
    run.sync()
    return compiled, t1 - t0, time.perf_counter() - t1


def bounce_rays(scene, o, d):
    """One cosine-sampled bounce ray per pixel off the primary hits (the
    routed cast's), dead rays parked: config 5's first bounce at one
    sample (``chip_smoke.py``'s path phase)."""
    from .kernels.traversal import cast_rays
    from .render import hit_attributes
    from .render.integrators import sample_cosine
    from .render.shade import SHADOW_EPS
    from .render.sorted_cast import park_dead_rays
    from .utils import prng

    at = hit_attributes(scene, o, d, cast_rays(scene, o, d))
    # the draw of split(PRNGKey(0), 3)[0]
    nd = sample_cosine(prng.PRNGKey(0, device=d.device), (0,), at.normal, True)
    return park_dead_rays(at.location + nd * SHADOW_EPS, nd, at.hit)


KERNEL_NAMES = {"K1": "wide_traverse_kernel", "K4": "paged_wide_kernel",
                "K5": "paged_binary_kernel", "K6": "paged_major_kernel"}


def _percentiles(xs: list) -> dict:
    q = np.percentile(np.asarray(xs, np.float64), [10, 50, 90])
    return {"p10": float(q[0]), "median": float(q[1]), "p90": float(q[2])}


def _kernel_times(prof, kernels: dict, runs: int) -> dict:
    """Per kernel of ``kernels`` (label -> kernel name), the percentiles
    of its launches' device ms in a trace, and the mean device ms per
    cast of K6's plan (its four kernels)."""
    from torch.autograd import DeviceType

    durations = {k: [] for k in kernels}
    plan_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "page_plan_" in e.name:
            plan_us += us
        for k, name in kernels.items():
            if name in e.name:
                durations[k].append(us / 1e3)
    out = {k: _percentiles(v) for k, v in durations.items()}
    out["plan"] = plan_us / 1e3 / runs if "K6" in kernels else None
    return out


def sweep_rays(run: Bench, columns: int, tag: str, casts: dict, o, d) -> dict:
    """Time each cast of ``casts`` (label -> (scene, wrapper)) on rays
    ``o``/``d`` in turns; prints a ``sweep_cast`` line per kernel and
    returns {label: cast-ms percentiles}."""
    fns = {k: (lambda sc=sc, cast=cast: cast(sc, o, d)) for k, (sc, cast) in casts.items()}
    for fn in fns.values():
        fn()
    run.sync()
    cast_ms = {k: [] for k in fns}
    cuda = run.device.type == "cuda"
    for _ in range(SWEEP_RUNS):
        for k, fn in fns.items():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                cast_ms[k].append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                cast_ms[k].append((time.perf_counter() - t0) * 1e3)
    kernel = {}
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SWEEP_RUNS):
                for fn in fns.values():
                    fn()
            run.sync()
        kernel = _kernel_times(prof, {k: KERNEL_NAMES[k] for k in fns}, SWEEP_RUNS)
    out = {}
    for k in fns:
        out[k] = _percentiles(cast_ms[k])
        line(run, sweep_cast=columns, rays=tag, n=d.numel() // 3, kernel=k, runs=SWEEP_RUNS,
             cast_ms=out[k], kernel_ms=kernel.get(k),
             plan_kernel_ms=kernel.get("plan") if k == "K6" else None)
    return out


def _beats(a: dict, b: dict) -> bool:
    """Whether cast times ``a`` beat ``b`` by more than the larger spread
    (10th to 90th percentile) of the two."""
    spread = max(a["p90"] - a["p10"], b["p90"] - b["p10"])
    return b["median"] - a["median"] > spread


def sweep_scene(run: Bench, columns: int) -> None:
    from .accel.wide import LEAF_ROWS
    from .kernels.paged_major import cast_rays_paged_major_cuda
    from .kernels.traversal import cast_rays_cuda
    from .render import Camera

    cache = tempfile.mkdtemp(prefix="bvh-sweep-")
    try:
        cold, cold_mesh_s, cold_compile_s = build_colonnade(run, columns, cache)
        del cold
        scene, warm_mesh_s, warm_compile_s = build_colonnade(run, columns, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    paged = scene.needs_paging()
    t0 = time.perf_counter()
    wide = scene.with_paging()
    run.sync()
    wide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binary = scene.with_paging(wide=False)
    run.sync()
    binary_s = time.perf_counter() - t0
    pw, pb = wide.paged, binary.paged
    leaves = scene.node_child_a < 0
    tables = {"K4": _mb(pw.node, pw.node_base, pw.page_tri0, pw.top_code, pw.top_box),
              "K5": _mb(pb.node, pb.node_base, pb.page_tri0, pb.top_code, pb.top_box),
              "K6": _mb(pw.node, pw.node_base, pw.page_tri0)}
    if not paged:
        tables["K1"] = _mb(scene.wide4.wnode, scene.wide4.wroot)
    line(run, sweep_scene=columns, segs=SEGS,
         real_triangles=int(scene.node_leaf_count[leaves].sum()), rows=scene.num_triangles,
         leaf_rows_limit=LEAF_ROWS, needs_paging=paged,
         attached=[k for k in ("wide4", "binary", "tlas", "paged")
                   if getattr(scene, k) is not None],
         cold_mesh_s=cold_mesh_s, cold_compile_s=cold_compile_s, warm_mesh_s=warm_mesh_s,
         warm_compile_s=warm_compile_s, paging_wide_s=wide_s, paging_binary_s=binary_s,
         pages=pw.num_pages, tri_rec_mb=_mb(scene.tri_rec), tables_mb=tables,
         scene_mb=scene_mb(scene))
    casts = {}
    if paged:
        line(run, sweep_cast=columns, kernel="K1", runs=0,
             why=f"K1 cannot address the scene: its {scene.num_triangles} triangle rows reach "
                 f"the leaf code's {LEAF_ROWS}")
    else:
        casts["K1"] = (scene, cast_rays_cuda)
    casts.update({"K4": (wide, cast_rays_paged_cuda), "K5": (binary, cast_rays_paged_cuda),
                  "K6": (wide, cast_rays_paged_major_cuda)})
    cam = Camera.looking(*SWEEP_SIZE, fov_deg=65.0, pose=CAMERA_POSE)
    p = cam.ray_params(scene.device)
    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    times = {"primary": sweep_rays(run, columns, "primary", casts, o, d)}
    bo, bd = bounce_rays(wide if paged else scene, o, d)
    times["bounce"] = sweep_rays(run, columns, "bounce", casts, bo, bd)
    verdict = {"k6_beats_k4": all(_beats(times[r]["K6"], times[r]["K4"]) for r in times),
               "k6_vs_k4_median_ms": sum(times[r]["K6"]["median"] - times[r]["K4"]["median"]
                                         for r in times)}
    if not paged:
        verdict["beats_k1"] = {k: {r: _beats(times[r][k], times[r]["K1"]) for r in times}
                               for k in ("K4", "K5", "K6")}
    line(run, sweep_verdict=columns, needs_paging=paged, **verdict)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's paged kernels on the colonnade")
    ap.add_argument("part", nargs="?", choices=["instanced", "sweep"],
                    help="instanced: the page-major part alone; sweep: the paging rule's "
                         "measurement")
    ap.add_argument("--columns", type=int, default=18,
                    help="columns per side (18: ~1.04M triangles, 36: ~4.1M)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_paged --device cuda needs a CUDA card")
    run = Bench(a.device, "cuda", frames=4)
    if a.part == "instanced":
        instanced_page_major(run, a.columns, SIZE)
    elif a.part == "sweep":
        for columns in SWEEP_COLUMNS:
            sweep_scene(run, columns)
    else:
        paged(run, a.columns, SIZE)


if __name__ == "__main__":
    main()
