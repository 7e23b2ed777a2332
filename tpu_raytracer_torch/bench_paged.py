"""The big-scene record of the port (counterpart of the root
``bench_paged.py``): the ~1.04M-triangle colonnade through the paged
kernels, one JSON line per measurement.

    python -m tpu_raytracer_torch.bench_paged                  # 18x18 columns
    python -m tpu_raytracer_torch.bench_paged --columns 6      # ~115k triangles
    python -m tpu_raytracer_torch.bench_paged instanced        # the K6 part alone
    python -m tpu_raytracer_torch.bench_paged --device cpu --columns 2

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
  4. per arity, the paged frame's rate (``render_image_paged``);
  5. ``instanced_page_major``: two posed instances of the colonnade through
     K6, its rate on the full frame, and the items of K6's plan
     (``paged_major.page_major_plan_cuda``): ``pages_streamed_per_frame``,
     the (instance, page) items some tile sees, each swept once by the
     tiles that see it (``tile_items_per_frame`` counts those sweeps), of
     ``item_grid`` items; then 96 sampled rays against the brute cast.

Every line carries ``card`` (the card's name and power limit; ``cpu`` on
the CPU, whose times are no device measurement). Frames are timed as the
root script times them: one warm frame, then the mean of 4, the card
synchronized at both ends. ``--columns`` replaces the root script's
``TRT_PAGED_COLUMNS``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .app.scenes import scene_colonnade, scene_colonnade_pair
from .bench_all import Bench
from .kernels import paged_major
from .kernels.paged import cast_rays_paged_cuda
from .kernels.traversal import unexplained_differences
from .render import Hit, RenderConfig, generate_rays
from .render.pipeline import render_image_paged
from .render.renderer import cast_rays_brute

# t of a sampled ray against the brute cast's (the root script's tolerance)
BRUTE_TOL = 1e-5
BRUTE_CHUNK = 16  # rays per brute cast: it is O(rays x triangles) in memory
SIZE = 512  # image width and height, as the root script fixes them


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


def paged(run: Bench, columns: int, size: int) -> None:
    t0 = time.perf_counter()
    scene, cam = scene_colonnade(size, size, columns=columns, segs=40, device=run.device)
    run.sync()
    line(run, scene_tris=scene.num_triangles, bvh_nodes=int(scene.node_child_a.shape[0]),
         compile_s=time.perf_counter() - t0)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's paged kernels on the colonnade")
    ap.add_argument("part", nargs="?", choices=["instanced"],
                    help="instanced: the page-major part alone")
    ap.add_argument("--columns", type=int, default=18,
                    help="columns per side (18: ~1.04M triangles, 36: ~4.1M)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_paged --device cuda needs a CUDA card")
    run = Bench(a.device, "cuda", frames=4)
    if a.part == "instanced":
        instanced_page_major(run, a.columns, SIZE)
    else:
        paged(run, a.columns, SIZE)


if __name__ == "__main__":
    main()
