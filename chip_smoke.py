#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's primary-ray main path (``tpu_raytracer_torch``) on the
flagship scene — BASELINE config 3: the 81,920-triangle
``procgen.blob(subdivisions=6)`` mesh, one instance, 1920x1088 camera,
flat shading — in phases, one line each:

  1. device: the card's name and power limit;
  2. build: kernel K1 (``kernels/csrc/wide_traverse.cu``) compiled with
     nvcc for sm_90a, with ptxas's register and spill report;
  3. K1 against its plain PyTorch version on the flagship rays: t bitwise
     (else the max ulp distance), tri/inst at non-tied t, hit fraction;
  4. the main path, ``render_image(backend="cuda")``: K1's launch count
     in that run, and its image against the plain path's image;
  5. config 1 (the textured cube, 64x64) against the exact CPU goldens
     ``tests/golden/config1_cube_64.npy`` and ``cube_64.npy``;
  6. times from CUDA events: K1's cast, the full frame, the plain cast,
     and the frame's stages (raygen, cast, attributes, shade).

Then one JSON line of the kernels, the card line, and the result line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero and
prints no result; without CUDA it exits 2 before importing the port.
The port runs without JAX: ``jax`` is blocked from being imported.
"""

import json
import os
import sys
import time

import numpy as np
import torch

# maximum ulp distance of K1's t from the plain version's (both built
# without FMA contraction, so they must agree bit for bit)
T_MAX_ULP = 0
# mismatched pixels allowed against the CPU goldens: none expected; the
# JAX package's own TPU check allows 4 nearest-texel flips at checker
# boundaries (UV rounding differs between devices)
GOLDEN_MAX_MISMATCH = 4
# hit fraction of the flagship frame as read by the JAX package on the
# same geometry (BENCH_r05.json): a property of the geometry
FLAGSHIP_HIT_FRACTION = 0.6712
HIT_FRACTION_TOL = 0.002


def phase(tag, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{tag}] {parts}", flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def event_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ulps between same-signed finite f32 values (int32 view difference)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def main():
    # 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    sys.modules["jax"] = None  # the port must not need JAX
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_raytracer_torch.app.scenes import scene_bunny, scene_cube
    from tpu_raytracer_torch.kernels import build, traversal
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, render,
        render_image, shade_primary,
    )
    from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen
    from tpu_raytracer_torch.utils.device import card_line

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", name=repr(name), count=torch.cuda.device_count(), card=repr(card),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build_cuda()
    build.load("cuda")
    log = build.build_log(lib_path).splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    phase("build", kernel="K1", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=lib_path.name, command=repr(log[0]), ptxas=repr(" | ".join(ptxas)))
    check("code=sm_90a" in log[0] and "--fmad=false" in log[0],
          "K1 was not built for sm_90a with --fmad=false")

    # 3. K1 against the plain version on the flagship -------------------
    t0 = time.perf_counter()
    scene, cam = scene_bunny(1920, 1088, device=dev)
    phase("scene", triangles=scene.num_triangles, wide_nodes=scene.wide4.wcode.shape[0],
          wide_depth=scene.wide4.depth, max_leaf=scene.wide4.max_leaf,
          build_s=f"{time.perf_counter() - t0:.2f}")
    p = cam.ray_params(dev)
    origin, dirs = generate_rays(cam.width, cam.height, p["K_inv"], p["D"],
                                 p["pose"], p["inv_pose"])
    hk = traversal.cast_rays_cuda(scene, origin, dirs)
    hp = traversal.cast_rays_wide_torch(scene, origin, dirs)
    torch.cuda.synchronize()
    t_diff = hk.t.view(torch.int32) != hp.t.view(torch.int32)
    n_t = int(t_diff.sum())
    max_ulp = int(ulp_distance(hk.t, hp.t).max())
    max_abs = float((hk.t.double() - hp.t.double()).abs().max())
    tied = ~t_diff
    n_tri = int(((hk.tri != hp.tri) & ~tied).sum())
    n_inst = int(((hk.inst != hp.inst) & ~tied).sum())
    n_tie_flips = int(((hk.tri != hp.tri) & tied).sum())
    hit_frac = float((hk.tri >= 0).float().mean())
    phase("k1_vs_plain", rays=hk.t.numel(), t_bitwise_diff=n_t, max_ulp=max_ulp,
          max_abs_err=max_abs, tri_diff_untied=n_tri, inst_diff_untied=n_inst,
          tri_flips_at_tied_t=n_tie_flips, hit_fraction=f"{hit_frac:.4f}")
    check(max_ulp <= T_MAX_ULP, f"K1 t differs from the plain walk by {max_ulp} ulp")
    check(n_tri == 0 and n_inst == 0, "K1 tri/inst differ from the plain walk")
    check(abs(hit_frac - FLAGSHIP_HIT_FRACTION) <= HIT_FRACTION_TOL,
          f"hit fraction {hit_frac:.4f} vs {FLAGSHIP_HIT_FRACTION}")

    # 4. main path ------------------------------------------------------
    config = RenderConfig(cam.width, cam.height, backend="cuda")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    traversal.LAUNCHES = 0
    img = render_image(config, scene, *args)
    torch.cuda.synchronize()
    launches = traversal.LAUNCHES
    hit = hit_attributes(scene, origin, dirs, hp)
    img_plain = shade_primary(scene, hit)
    n_img = int((img != img_plain).any(-1).sum())
    img_np = img.cpu().numpy()
    sky = np.array([255, 204, 153], np.uint8)
    img_hit_frac = float((img_np != sky).any(-1).mean())
    phase("main_path", shape=tuple(img.shape), dtype=img.dtype, k1_launches=launches,
          pixels_vs_plain=n_img, image_hit_fraction=f"{img_hit_frac:.4f}")
    check(launches >= 1, "render_image did not launch K1")
    check(img.shape == (1088, 1920, 3) and img.dtype == torch.uint8, "bad image")
    check(n_img == 0, f"{n_img} pixels differ from the plain path")

    # 5. config 1 against the CPU goldens -------------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    cube, cube_cam = scene_cube(64, device=dev)
    mism1 = _golden_mismatch(render(cube_cam, cube, backend="cuda"),
                             os.path.join(root, "tests/golden/config1_cube_64.npy"))
    tex = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(64, 8))
    tex.add_material(mat)
    tex.add_mesh(objloader.loads(procgen.cube_obj()))
    tex.add_mesh_instance(MeshInstance(0, 0))
    cam64 = Camera.looking(64, 64, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    mism2 = _golden_mismatch(render(cam64, tex.compile(dev), backend="cuda"),
                             os.path.join(root, "tests/golden/cube_64.npy"))
    phase("golden", config1_cube_64_mismatch=mism1, cube_64_mismatch=mism2)
    check(max(mism1, mism2) <= GOLDEN_MAX_MISMATCH,
          f"golden mismatch {mism1}/{mism2} pixels (nearest-texel flips at "
          "checker boundaries allow at most 4)")

    # 6. time -----------------------------------------------------------
    cast = lambda: traversal.cast_rays_cuda(scene, origin, dirs)
    frame = lambda: render_image(config, scene, *args)
    for fn in (cast, frame):
        fn()
    cast_ms = min(event_ms(cast, 10) for _ in range(5))
    frame_ms = sorted(event_ms(frame, 10) for _ in range(5))
    plain_ms = event_ms(lambda: traversal.cast_rays_wide_torch(scene, origin, dirs), 1)
    rays = cam.width * cam.height
    phase("time", card=repr(card), k1_cast_ms=f"{cast_ms:.4f}",
          k1_mrays_s=f"{rays / cast_ms / 1e3:.2f}",
          frame_ms_best=f"{frame_ms[0]:.4f}", frame_ms_median=f"{frame_ms[2]:.4f}",
          fps=f"{1e3 / frame_ms[0]:.2f}", plain_cast_ms=f"{plain_ms:.2f}")
    attrs = hit_attributes(scene, origin, dirs, hk)
    stages = {
        "raygen": lambda: generate_rays(cam.width, cam.height, *args),
        "cast": cast,
        "attrs": lambda: hit_attributes(scene, origin, dirs, hk),
        "shade": lambda: shade_primary(scene, attrs),
    }
    phase("stages", card=repr(card), **{
        f"{k}_ms": f"{min(event_ms(fn, 10) for _ in range(3)):.4f}"
        for k, fn in stages.items()})

    check("jax" not in sys.modules or sys.modules["jax"] is None, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "K1 wide_traverse (4-wide BVH nearest hit)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
        "replaces": "tpu_raytracer/kernels/dual.py:147",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": cast_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def _golden_mismatch(img: torch.Tensor, path: str) -> int:
    golden = np.load(path)
    return int((img.cpu().numpy() != golden).any(-1).sum())


if __name__ == "__main__":
    main()
