#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths (``tpu_raytracer_torch``) through kernels K1 (the
4-wide BVH cast) and K3 (the two-level TLAS cast) in phases, one line
each:

  1. device: the card's name and power limit;
  2. build: K1 (``kernels/csrc/wide_traverse.cu``) and K3
     (``kernels/csrc/tlas_traverse.cu``) compiled with one nvcc command
     for sm_90a, with ptxas's register, stack and spill report;
  3. the flagship, BASELINE config 3 (the 81,920-triangle
     ``procgen.blob(subdivisions=6)`` mesh, one instance, 1920x1088
     camera, flat shading): K1 against its plain PyTorch version, t
     bitwise (else the max ulp distance), tri/inst at non-tied t, hit
     fraction;
  4. the primary main path, ``render_image(backend="cuda")`` on the
     flagship: K1's launch count in that run, and its image against the
     plain path's image;
  5. config 1 (the textured cube, 64x64) against the exact CPU goldens;
  6. K3 against its plain version on config 4 (four posed instances) at
     1920x1088: primary rays, their first-bounce reflection rays, and the
     16-instance scene's primary rays;
  7. any-hit: K1 on the flagship's shadow rays and K3 on config 4's must
     give the plain nearest-hit cast's blocked/clear answer on every ray;
     the flagship rendered with hard shadows (K1 nearest + any hit);
  8. the Whitted main path, ``render_image_whitted`` on config 4 at
     1920x1088: K3's launch count in the frame, and its image against the
     same integrator on the plain casts;
  9. configs 2, 3 and 4 at their CPU golden sizes against those goldens;
 10. the demo driver (``app.driver.run("demo", ...)``), 3 frames at
     1920x1088: K3's launch count;
 11. times from CUDA events: the casts of K1, K1 any-hit and K3 beside
     their plain versions, the flagship and Whitted frames, and the
     stages of each frame.

Then one JSON line of the kernels, the card line, and the result line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero and
prints no result; without CUDA it exits 2 before importing the port.
The port runs without JAX: ``jax`` is blocked from being imported.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# maximum ulp distance of K1's and K3's t from their plain versions'
# (built without FMA contraction, so they must agree bit for bit)
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


def compare_hits(hk, hp):
    """Kernel hit record against the plain version's: (t bit
    differences, max ulp, max abs error, untied tri diffs, untied inst
    diffs, tri flips at tied t)."""
    t_diff = hk.t.view(torch.int32) != hp.t.view(torch.int32)
    tied = ~t_diff
    return (int(t_diff.sum()), int(ulp_distance(hk.t, hp.t).max()),
            float((hk.t.double() - hp.t.double()).abs().max()),
            int(((hk.tri != hp.tri) & ~tied).sum()), int(((hk.inst != hp.inst) & ~tied).sum()),
            int(((hk.tri != hp.tri) & tied).sum()))


def best_and_median_ms(fn, loops: int = 5, n: int = 10):
    times = sorted(event_ms(fn, n) for _ in range(loops))
    return times[0], times[len(times) // 2]


def main():
    # 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    sys.modules["jax"] = None  # the port must not need JAX
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_raytracer_torch.app import driver
    from tpu_raytracer_torch.app.scenes import (
        scene_bunny, scene_cornell, scene_cube, scene_instances, scene_instances16,
    )
    from tpu_raytracer_torch.core.vecmath import FLT_MAX, normalize
    from tpu_raytracer_torch.kernels import build, tlas, traversal
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, render, render_image,
        render_image_whitted, shade_primary,
    )
    from tpu_raytracer_torch.render.integrators import _reflect
    from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION, SHADOW_EPS
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
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
    ptxas = [ln.strip() for ln in log
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    phase("build", kernels="K1+K3", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=lib_path.name, command=repr(log[0]), ptxas=repr(" | ".join(ptxas)))
    check("code=sm_90a" in log[0] and "--fmad=false" in log[0],
          "K1/K3 were not built for sm_90a with --fmad=false")
    check("tlas_traverse.cu" in log[0] and "wide_traverse.cu" in log[0],
          "K1 and K3 were not built into one library")

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
    n_t, max_ulp, max_abs, n_tri, n_inst, n_tie_flips = compare_hits(hk, hp)
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
    golden = lambda g: os.path.join(root, "tests", "golden", g + ".npy")
    cube, cube_cam = scene_cube(64, device=dev)
    mism1 = _golden_mismatch(render(cube_cam, cube, backend="cuda"), golden("config1_cube_64"))
    tex = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(64, 8))
    tex.add_material(mat)
    tex.add_mesh(objloader.loads(procgen.cube_obj()))
    tex.add_mesh_instance(MeshInstance(0, 0))
    cam64 = Camera.looking(64, 64, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    mism2 = _golden_mismatch(render(cam64, tex.compile(dev), backend="cuda"), golden("cube_64"))
    phase("golden", config1_cube_64_mismatch=mism1, cube_64_mismatch=mism2)
    check(max(mism1, mism2) <= GOLDEN_MAX_MISMATCH,
          f"golden mismatch {mism1}/{mism2} pixels (nearest-texel flips at "
          "checker boundaries allow at most 4)")

    # 6. K3 against its plain version -----------------------------------
    inst4, cam4 = scene_instances(1920, 1088, device=dev)
    p4 = cam4.ray_params(dev)
    args4 = (p4["K_inv"], p4["D"], p4["pose"], p4["inv_pose"])
    o4, d4 = generate_rays(cam4.width, cam4.height, *args4)
    h4 = tlas.cast_rays_tlas_cuda(inst4, o4, d4)
    a4 = hit_attributes(inst4, o4, d4, h4)
    rd4 = normalize(_reflect(d4, a4.normal))
    refl4 = park_dead_rays(a4.location + rd4 * SHADOW_EPS, rd4, a4.hit)
    inst16, cam16 = scene_instances16(1920, 1088, device=dev)
    p16 = cam16.ray_params(dev)
    o16, d16 = generate_rays(cam16.width, cam16.height, p16["K_inv"], p16["D"], p16["pose"],
                             p16["inv_pose"])
    k3_sets = {"config4_primary": (inst4, o4, d4), "config4_reflection": (inst4, *refl4),
               "instances16_primary": (inst16, o16, d16)}
    k3_max_abs = 0.0
    for tag, (sc, ro, rd) in k3_sets.items():
        hk3 = tlas.cast_rays_tlas_cuda(sc, ro, rd)
        hp3 = tlas.cast_rays_tlas_torch(sc, ro, rd)
        torch.cuda.synchronize()
        n_t, max_ulp, max_abs, n_tri, n_inst, n_flip = compare_hits(hk3, hp3)
        k3_max_abs = max(k3_max_abs, max_abs)
        phase("k3_vs_plain", rays=tag, n=hk3.t.numel(), instances=sc.num_instances,
              tlas_nodes=sc.tlas.code.shape[0], tlas_depth=sc.tlas.depth,
              t_bitwise_diff=n_t, max_ulp=max_ulp, max_abs_err=max_abs,
              tri_diff=int((hk3.tri != hp3.tri).sum()), inst_diff=int((hk3.inst != hp3.inst).sum()),
              hit_fraction=f"{float((hk3.tri >= 0).float().mean()):.4f}")
        check(n_t == 0, f"K3 t differs from the plain walk on {tag}")
        check(torch.equal(hk3.tri, hp3.tri) and torch.equal(hk3.inst, hp3.inst),
              f"K3 tri/inst differ from the plain walk on {tag}")

    # 7. any hit --------------------------------------------------------
    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32, device=dev))

    def shadow_rays(sc, ro, rd, h):
        at = hit_attributes(sc, ro, rd, h)
        return park_dead_rays(at.location + ldir * SHADOW_EPS, ldir.expand(at.location.shape),
                              at.hit)

    shadow1 = shadow_rays(scene, origin, dirs, hk)
    shadow4 = shadow_rays(inst4, o4, d4, h4)
    occ_err = {}
    for tag, sc, rays, cast, plain in (
        ("K1_flagship", scene, shadow1, traversal.cast_rays_cuda, traversal.cast_rays_wide_torch),
        ("K3_config4", inst4, shadow4, tlas.cast_rays_tlas_cuda, tlas.cast_rays_tlas_torch),
    ):
        occ = cast(sc, *rays, occlusion=True)
        near = cast(sc, *rays)
        plain_occ = plain(sc, *rays, occlusion=True)
        torch.cuda.synchronize()
        blocked = plain_occ.t < 0
        n_bad = int(((occ.t < 0) != blocked).sum() + ((near.t < FLT_MAX) != blocked).sum())
        n_vals = int(((occ.t != plain_occ.t)).sum())
        occ_err[tag] = float((occ.t.double() - plain_occ.t.double()).abs().max())
        phase("occlusion", kernel=tag, rays=occ.t.numel(),
              occluded_fraction=f"{float(blocked.float().mean()):.4f}",
              answer_diff_vs_plain_nearest=n_bad, t_diff_vs_plain_any_hit=n_vals)
        check(n_bad == 0 and n_vals == 0, f"{tag} any-hit answers differ from the nearest cast")
    shadow_cfg = RenderConfig(cam.width, cam.height, lighting="lambert_shadow")
    traversal.LAUNCHES = 0
    img_sh = render_image(shadow_cfg, scene, *args)
    torch.cuda.synchronize()
    k1_shadow_launches = traversal.LAUNCHES
    phase("shadow_path", scene="flagship", lighting="lambert_shadow",
          k1_launches=k1_shadow_launches,
          lit_differs_from_flat=int((img_sh != img).any(-1).sum()))
    check(k1_shadow_launches == 2, "the shadowed flagship frame did not launch K1 twice")

    # 8. Whitted main path ----------------------------------------------
    wcfg = RenderConfig(cam4.width, cam4.height, backend="cuda")
    tlas.LAUNCHES = 0
    traversal.LAUNCHES = 0
    img_w = render_image_whitted(wcfg, inst4, *args4)
    torch.cuda.synchronize()
    k3_launches = tlas.LAUNCHES
    k1_in_whitted = traversal.LAUNCHES
    saved_cast = traversal.cast_rays
    traversal.cast_rays = _plain_router(traversal, tlas)
    img_w_plain = render_image_whitted(wcfg, inst4, *args4)
    traversal.cast_rays = saved_cast
    n_w = int((img_w != img_w_plain).any(-1).sum())
    phase("whitted", scene="config4", shape=tuple(img_w.shape), k3_launches=k3_launches,
          k1_launches=k1_in_whitted, pixels_vs_plain=n_w,
          image_mean=f"{float(img_w.float().mean()):.3f}")
    # 3 nearest casts (primary + 2 bounces) and 3 any-hit shadow casts
    check(k3_launches == 6, f"the Whitted frame launched K3 {k3_launches} times, not 6")
    check(n_w == 0, f"{n_w} Whitted pixels differ from the plain casts' image")

    # 9. configs 2-4 against the CPU goldens ----------------------------
    cornell, ccam = scene_cornell(64, device=dev)
    bunny, bcam = scene_bunny(96, 96, subdivisions=4, device=dev)
    inst64, icam = scene_instances(64, 64, device=dev)
    mism = {}
    for gname, fn, lighting, sc, gcam in (
        ("config2_cornell_64", render_image, "lambert_shadow", cornell, ccam),
        ("config3_bunny_96", render_image, "blinn_phong", bunny, bcam),
        ("config4_instances_whitted_64", render_image_whitted, "flat", inst64, icam),
    ):
        gp = gcam.ray_params(dev)
        gimg = fn(RenderConfig(gcam.width, gcam.height, backend="cuda", lighting=lighting), sc,
                  gp["K_inv"], gp["D"], gp["pose"], gp["inv_pose"])
        mism[gname] = _golden_mismatch(gimg, golden(gname))
    phase("golden2", **{f"{k}_mismatch": v for k, v in mism.items()})
    check(max(mism.values()) <= GOLDEN_MAX_MISMATCH,
          f"golden mismatch {mism} (at most {GOLDEN_MAX_MISMATCH} pixels each)")

    # 10. demo driver ---------------------------------------------------
    tlas.LAUNCHES = 0
    demo = driver.run("demo", 1920, 1088, frames=3,
                      out=os.path.join(tempfile.mkdtemp(), "demo.png"), device="cuda")
    demo_launches = tlas.LAUNCHES
    phase("demo", shape=tuple(demo.shape), k3_launches=demo_launches,
          image_hit_fraction=f"{float((demo.numpy() != sky).any(-1).mean()):.4f}")
    check(demo_launches >= 3, "the demo driver did not launch K3 once per frame")

    # 11. time ----------------------------------------------------------
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

    k1_any = lambda: traversal.cast_rays_cuda(scene, *shadow1, occlusion=True)
    k3_cast = lambda: tlas.cast_rays_tlas_cuda(inst4, o4, d4)
    wframe = lambda: render_image_whitted(wcfg, inst4, *args4)
    for fn in (k1_any, k3_cast, wframe):
        fn()
    k1_any_ms = min(event_ms(k1_any, 10) for _ in range(5))
    k3_ms = min(event_ms(k3_cast, 10) for _ in range(5))
    w_best, w_median = best_and_median_ms(wframe)
    k1_any_plain_ms = event_ms(
        lambda: traversal.cast_rays_wide_torch(scene, *shadow1, occlusion=True), 1)
    k3_plain_ms = event_ms(lambda: tlas.cast_rays_tlas_torch(inst4, o4, d4), 1)
    phase("time2", card=repr(card), k3_cast_ms=f"{k3_ms:.4f}",
          k3_mrays_s=f"{d4.numel() // 3 / k3_ms / 1e3:.2f}",
          k3_plain_ms=f"{k3_plain_ms:.2f}", k1_any_hit_ms=f"{k1_any_ms:.4f}",
          k1_any_hit_plain_ms=f"{k1_any_plain_ms:.2f}",
          whitted_frame_ms_best=f"{w_best:.4f}", whitted_frame_ms_median=f"{w_median:.4f}",
          whitted_fps=f"{1e3 / w_best:.2f}")
    phase("whitted_stages", card=repr(card), **_whitted_stages(traversal, wframe))

    check("jax" not in sys.modules or sys.modules["jax"] is None, "jax was imported")
    print(json.dumps({"kernels": [
        {
            "name": "K1 wide_traverse (4-wide BVH nearest hit)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
            "replaces": "tpu_raytracer/kernels/dual.py:147",
            "launches": launches,
            "max_abs_err": max_abs,
            "ms": cast_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "K1 wide_traverse any-hit mode (shadow rays; launches: the shadowed "
                    "flagship frame, primary + shadow cast)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
            "replaces": "tpu_raytracer/kernels/dual.py:147",
            "launches": k1_shadow_launches,
            "max_abs_err": occ_err["K1_flagship"],
            "ms": k1_any_ms,
            "plain_ms": k1_any_plain_ms,
        },
        {
            "name": "K3 tlas_traverse (TLAS + 4-wide BLAS, nearest and any hit; launches: "
                    "the config 4 Whitted frame)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/tlas_traverse.cu",
            "replaces": "tpu_raytracer/kernels/tlas.py:176",
            "launches": k3_launches,
            "max_abs_err": max(k3_max_abs, occ_err["K3_config4"]),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def _plain_router(traversal, tlas):
    """``traversal.cast_rays`` with the kernels' plain versions in place
    of the kernels, on the rays' own device."""
    def cast(scene, origin, directions, occlusion=False):
        if scene.num_instances >= 2 and scene.tlas is not None:
            return tlas.cast_rays_tlas_torch(scene, origin, directions, occlusion)
        return traversal.cast_rays_wide_torch(scene, origin, directions, occlusion)

    return cast


def _whitted_stages(traversal, wframe) -> dict:
    """One Whitted frame with CUDA events around every cast: the nearest
    casts' and the any-hit (shadow) casts' milliseconds, and the rest of
    the frame (raygen, attributes, shading)."""
    saved = traversal.cast_rays
    marks = []

    def timed(scene, origin, directions, occlusion=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        hit = saved(scene, origin, directions, occlusion)
        end.record()
        marks.append(("any_hit" if occlusion else "nearest", start, end))
        return hit

    traversal.cast_rays = timed
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wframe()
    end.record()
    traversal.cast_rays = saved
    end.synchronize()
    frame_ms = start.elapsed_time(end)
    out = {"frame_ms": f"{frame_ms:.4f}"}
    for kind in ("nearest", "any_hit"):
        ms = [s.elapsed_time(e) for k, s, e in marks if k == kind]
        out[f"{kind}_casts"] = len(ms)
        out[f"{kind}_ms"] = "/".join(f"{m:.4f}" for m in ms)
    cast_total = sum(s.elapsed_time(e) for _, s, e in marks)
    out["rest_ms"] = f"{frame_ms - cast_total:.4f}"
    return out


def _golden_mismatch(img: torch.Tensor, path: str) -> int:
    golden = np.load(path)
    return int((img.cpu().numpy() != golden).any(-1).sum())


if __name__ == "__main__":
    main()
