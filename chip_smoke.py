#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths (``tpu_raytracer_torch``) through kernels K1 (the
4-wide BVH cast), K2 (the binary BVH cast), K3 (the two-level TLAS cast)
the paged kernels K4 (4-wide pages), K5 (binary pages) and K6
(page-major), and the frame stages around the cast, S1 (raygen), S2 (hit
attributes), S3 (primary shade), S4 (the path tracer's and AO's
sample), S5 (the Whitted shade) and S6 (the path tracer's bounce), in
phases, one line each:

  1. device: the card's name and power limit;
  2. build: K1 and K2 (``kernels/csrc/wide_traverse.cu``), K3
     (``kernels/csrc/tlas_traverse.cu``), K4/K5
     (``kernels/csrc/paged_traverse.cu``), K6
     (``kernels/csrc/paged_major.cu``), K6's plan
     (``kernels/csrc/page_plan.cu``) and S1-S6 (``kernels/csrc/frame.cu``)
     compiled for sm_90a by one nvcc per source, all started together,
     and linked into one library, with
     ptxas's report of each kernel (registers, stack frame, spills, static
     shared memory) and its dynamic shared memory (the short stack of
     K1-K6);
     then the design of K1-K6, which share the walk of
     ``kernels/csrc/walk.cuh`` (``[walk_design]``: the short stack's ring
     slots, persistent warps, the node records, each kernel's launch at
     1920x1088);
  3. the flagship, BASELINE config 3 (the 81,920-triangle
     ``procgen.blob(subdivisions=6)`` mesh, one instance, 1920x1088
     camera, flat shading): K1 against its plain PyTorch version, t
     bitwise (else the max ulp distance), tri and inst equal, hit
     fraction;
  4. the primary main path, ``render_image(backend="cuda")`` on the
     flagship: K1's and S1-S3's launch counts in that run (each stage
     once), and its image against the frame through plain versions alone
     (S1's, K1's, S2's and S3's);
  5. config 1 (the textured cube, 64x64) against the exact CPU goldens;
     then ``[frame_kernels]``: S1, S2 and S3 against their plain versions
     (``generate_rays_torch``, ``hit_attributes_torch``,
     ``shade_primary_torch``), every field bit for bit on every ray,
     misses included: the flagship (K1's carried n and the redo), config
     4 (K3's carried u, v and n, the redo, the reflection rays' per-ray
     origins), the textured cube (1088x1088) and the demo with its sky map
     under the reference fisheye calibration, each with ``exact_math`` on
     and off, S2 in both normal modes, S3 in every mode, the bilinear and
     trilinear filters and point lights, shadowed or not; each kernel's
     device ms on the flagship beside its bound (bytes: the per-ray
     inputs and outputs and each table row the rays name, once) and its
     plain version's ms (``[frame_kernels_time]``); then ``[sample_kernel]``:
     S4 against its plain chain (``sample_cosine_torch``: ``utils/prng.py``'s
     threefry ops and ``_cosine_sample`` on the card) at both call sites,
     AO's draws on the flagship's normals and the path tracer's on the
     batch expanded over its samples (stride 0) or contiguous, with the
     lobe uniforms, the sequential chain of two words and the basis' edge
     normals, directions and uniforms bit for bit; its launches in eager
     AO and path frames (one a draw); and ``[frame_kernels_time]`` rows for
     an AO and a path draw at 1920x1088 beside their bound (the uint32
     hash operations over the card's int32 rate, the bytes over its
     bandwidth) and the plain chain's ms; then ``[whitted_shade]``: S5
     against its plain version (``whitted_shade_torch``) on the three
     bounces of config 4's 1920x1088 Whitted frame and of the demo under
     its sky map, every output bit for bit, its launches in an eager and a
     compiled Whitted frame (one a bounce), and a ``[frame_kernels_time]``
     row for config 4's first bounce beside its byte bound;
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
     1920x1088 through the compiled ``render_image``: one graph, replayed
     3 times, K3 once per replay;
 11. times: the casts of K1, K1 any-hit and K3 (CUDA events and their
     kernels' device time) beside their plain versions; K3's kernel time
     and bound on each kind of ray the Whitted frame casts (primary,
     reflection, shadow: ``[time_k3]``). The benchmark (``python3 -m
     rtbench``) times the frames and their stages;
 12. the paged path on config 5, the colonnade of ``bench_paged.py``
     (``scene_colonnade(columns=18, segs=40)``: ~1.04M triangles, one
     instance): host build seconds (the native BVH builder), triangle,
     page and top-tree counts, 4-wide and binary page tables;
 13. K4, K5 and K6 against their plain versions on the 1920x1088 rays (t
     bitwise, tri and inst equal), K6's plan from the card against the
     plain plan (item order and per-tile lists bitwise; ``[plan_vs_plain]``),
     and K4-K6 against K1 casting the same
     unpaged scene: equal but on a few rays in 10^5, each explained by
     the order of box tests (``traversal.unexplained_differences``: a
     hit accepted up to EDGE_EPS outside its triangle can lie outside
     its leaf box, and a walk that has lowered t_best first culls it);
 14. 192 sampled 512x512 rays (``bench_paged.py``'s sample) through K4,
     K5 and K6 against ``cast_rays_brute``: t within 1e-5, or a hit the
     brute cast finds up to EDGE_EPS outside its triangle and leaf box,
     which the walks cull (``brute_unexplained``);
 15. K6 on the two-instance colonnade (``bench_paged.py:
     instanced_page_major``) at 512x512, from that recipe's camera (which
     sees instance 0 only) and from an aerial camera that sees both
     instances: against its plain version, K1, and 96 sampled rays
     against the brute cast, and its card plan against the plain plan;
 16. the paged main paths: ``render_image`` on the colonnade at
     1920x1088 through the ``paged`` backend (4-wide tables: K4; binary:
     K5) and ``paged_major`` (K6 and its plan), each kernel's launch
     count in that frame and the image against the plain casts' image;
 17. times: K4, K5, K6 (its plan included) and K1 per cast on the
     colonnade at 512x512 and 1920x1088, their kernels, K6's plan on the
     card and the plain plan, and each frame;
 18. config 5 as ``bench_all.py`` runs it: ``scene_colonnade`` at its
     defaults (256,002 triangles), 512x512, 2 samples, 2 bounces, a
     5-pose ``fly_through`` with key k for frame k; the binary depth;
 19. K2 against its plain version (t bitwise, tri and inst equal), its
     any-hit answers against its nearest hits, and K1 on the same rays
     (every difference explained by box order), on the flagship's
     primary rays and on frame 0's first bounce rays ([2, 512, 512]),
     with K2's and K1's kernel times, K2's any-hit kernel time and bound
     on the flagship's shadow rays (its answers against its nearest
     hits), and K1's on the bounce rays in pixel order and in the
     coherence sort's order;
 20. the path main path, ``render_image_path_traced`` over the
     fly-through through ``bvh`` (K2) and ``cuda`` (K1): launches per
     frame (3: primary, batched bounce, any-hit tail; 6 with
     ``path_lights``), frame 0 against the plain casts' frame, the
     unsorted bounce casts of ``cuda`` (the default) against sorted, bvh
     against cuda;
 21. ``config5_colonnade_path_64`` against its CPU golden;
 22. ``render_image_ao`` (8 samples) and the path frame denoised (3
     iterations) against their plain-cast frames;
 23. times: the path frame at 512x512 (config 5) and at 1920x1088 (the
     driver's 3 bounces, 4 samples) through both backends, and the
     denoiser's 3 iterations on its radiance; then ``[path_bounce]``: S6
     against its plain version (``path_bounce_torch``) on the bounces of
     config 5's 2-sample path frame at 1920x1088 (the first on the primary
     rows expanded over the samples, the second, the fast tail; with NEE
     three full bounces), every output bit for bit, its launches in an
     eager and a compiled path frame (three a frame), and
     ``[frame_kernels_time]`` rows for each bounce beside its byte bound;
 24. ``[flatten]``: config 4 with its instances baked into one mesh
     (``scene_instances(flatten=True)``, bench_all's config 4b): K1
     carrying u, v and n against its plain version on the primary and
     reflection rays (every field bitwise), the Whitted frame (K1 6
     times, 3 of them carrying, K3 never) against its plain casts' frame
     and against the instanced frame (at least 97% of the pixels equal:
     exact-t ties and the bake's last bits), and K1's device time beside
     K3's on the instanced scene, in turns, with and without the carry;
 25. ``[flatten16]``: the same for the 16 instances (config 6b), primary
     rays and the primary frame;
 26. ``[presplit]``: the colonnade of phase 12 built with ``presplit=1.3``
     (duplicated triangle references with clipped boxes): K1, K4, K5 and
     K6 (with its card plan) bitwise against their plain versions, against
     K1 on the same tree and on the unsplit tree (each difference
     explained by box order against the brute cast of its own tree:
     ``cross_tree_unexplained``), the three paged frames against their
     plain casts' frames, and each kernel's device time on the unsplit and
     the split tree in turns;
 27. ``[optimize]``: config 5's colonnade with two reinsertion rounds
     (``opt_rounds=2``, bench_all's config 5b): SAH before and after, K1
     and K2 bitwise against their plain versions on the first bounce rays
     and against the plain tree, both path frames against their plain
     casts' frames, K1's and K2's device time on either tree in turns;
 28. ``[scene_io]``: config 5's colonnade saved and loaded, the flagship's
     mesh as an OBJ file through the native parser, ``compile_cached``
     cold and warm, the BVH disk cache cold and warm on the colonnade of
     phase 12 (each in a fresh temporary directory, every field equal);
 29. ``[texture_file]``: the cube's checkerboard as a PNG file through
     ``Material.upload_texture``, the 1920x1088 frame against the
     in-memory texture's;
 30. ``[shard_rows]``: row bands (``parallel.sharding``) on ranks started
     by ``parallel.spawn`` on this card: one rank under NCCL, two under
     gloo (NCCL refuses two ranks on one card), every card under NCCL
     where there are two or more (else ``[shard_multi_card] run=False``).
     The flagship (K1) and config 4's Whitted frame (K3) at 1920x1088,
     config 5's path frame at 512x512 (K1; band i sampled with
     ``fold_in(key, i)``, against the same bands rendered here), the 1M
     colonnade through ``paged`` (K4, K5) and ``paged_major`` (K6): every
     rank's frame bitwise equal to the unsharded one, each rank's
     launches, frame ms best and median beside the unsharded frame's;
 31. ``[shard_scene]``: the 1M colonnade flattened and split into one
     chunk per rank (``parallel.scene_shard``), K1 on 1920x1088 rays: the
     chunks' rows and table bytes against the whole scene's, K1's device
     time on a chunk against the whole scene, the combined cast against
     the lexicographic minimum of the ranks' own casts (bitwise), its t
     differences from the single-device cast of the flattened scene and
     how many no visit order explains (must be 0); per lighting (flat,
     ``lambert_shadow``, ``[shard_scene_frame]``) the pixels apart from
     the single-device frame, the collectives' CUDA-event ms, frame ms;
 32. ``[graph_shard]``: the row-band cases of phase 30 at each world size
     and the scene-shard primary (flat, ``lambert_shadow``), Whitted and
     path (512x512) frames of phase 31 at one NCCL rank, through their
     compiled entry points (``compiled_*``: one CUDA graph per rank; the
     scene shards' graphs hold the combine's NCCL collectives, counted as
     they are captured; the row bands are gathered after the replay): 0
     pixels from the eager sharded frame at 3 poses and from the frame
     through the plain stages at the first, a replay's launches
     those of the eager frame, the ranks alike, one entry per case,
     capture s, eager against replayed frames 21 times in turns; under
     gloo the scene shards' compiled entry points refuse the group;
     ``[shard_dryrun]``: ``python -m tpu_raytracer_torch.parallel.dryrun``
     (the compiled sharded entry points against the eager ones) on one
     rank of this card under NCCL and on two under gloo, at once;
 33. ``[app_web]``: the browser viewer on config 4 at 1920x1088, served on
     127.0.0.1 in a thread, in each mode (primary, whitted, path, ao):
     the served frame bitwise the entry point's at the same pose (path
     and AO with the same keys), K3's launches per replay of the mode's
     graph, the render and PNG-encode ms apart; the path sum held, held,
     dragged (1, 2, 1);
 34. ``[app_interactive]``: the terminal viewer's loop on the flagship
     with keys ``wwjd`` (the last frame bitwise ``render_image`` at the
     pose they reach, one graph replayed 5 times with one K1 launch a
     replay, frame ms) and 3 frames in path mode (bitwise the sum of 3
     one-sample frames);
 35. ``[app_profiling]``: ``trace()`` around three compiled flagship
     frames and an eager path frame writes a trace naming K1's kernel and
     holding the port's ``rt.frame.<n>``, ``rt.cast`` and ``rt.sample`` spans;
 36. ``[app_driver]``: the demo driver's out.png against ``overlay_fps``
     of the frame it returns (unlabelled where OpenCV does not import);
 37. ``[examples]``: each ``examples/torch/*.py --device cuda`` in a
     process of its own, all started together, exit 0 and their PNGs,
     each through its compiled entry point (``02_animation``'s five frame
     times: frame 0 captures, frames 1-4 replay);
 38. ``[bench_scripts]``: ``python -m tpu_raytracer_torch.bench_all bunny
     instances`` (every key on each line) and ``python -m
     tpu_raytracer_torch.bench_paged --columns 6`` (its sampled casts close
     to the brute cast's);
 39. ``[big_scene]`` (run after ``[presplit]``): the 1M colonnade's route
     (K1), then the colonnade of 26 columns (2,163,202 triangles, the
     smallest ``segs=40`` colonnade past the leaf code's 2,097,152 rows)
     compiled with the defaults: its rows, ``needs_paging()``, the tables
     attached (page tables only), the host build; the ``cuda`` backend's
     cast launching K4 once, bitwise the forced ``paged`` cast, the plain
     version and the ``bvh`` backend's cast, its any-hit answers those of
     the nearest hits, 192 sampled rays against the brute cast (0
     unexplained); the flat, ``lambert_shadow``, Whitted and 2 spp path
     frames through ``cuda`` and the flat frame through ``bvh``, each
     launching K4 alone, bitwise the ``paged`` backend's frame, best and
     median ms; K4's cast and kernel ms and bound there;
 40. ``[graph]`` (after the shard phases): the compiled entry points
     (``render/compiled.py``: one CUDA graph per static config, replayed
     with the camera, the instances and the key copied in) on the
     flagship (flat, ``lambert_shadow``), config 4 (Whitted, AO, the AOV
     pass), config 5's path frame at 512x512 through ``cuda`` and ``bvh``
     and the 1M colonnade through ``paged`` and ``paged_major``: each
     eager frame once under ``torch.cuda.set_sync_debug_mode("error")``
     (no host sync), then 3 poses, each replay bitwise the eager frame,
     a replay's launches those of the eager frame (S1 once, S2, and S3
     once in a primary frame), one entry per case, and the frame at the
     first pose 0 pixels from the same frame through the plain stages
     (``plain_stages``: no S1-S5 launch);
     config 4 after ``update_instance`` and the path frame with a new key
     replayed by the same entry, a scene of the same shapes with other
     tables in an entry of its own, and the capture's one-off seconds;
 41. ``[ao_bound]`` (after phase 23): K1 on AO's first sample draw of the
     benchmark's AO cell (the colonnade at its defaults, 1920x1080, poses
     0, 150, 300 and 450 of its lap, radius 1.0) unbounded and bounded by
     the radius: each cast's device ms in turns (unbounded, bounded,
     bounded, unbounded), both bitwise their plain walks on a row sample
     (every 12th row), and the plain walks' pops and triangle tests there:
     the mean and 99th percentile per live ray, and the mean of their
     maxima over 32 consecutive rays (a warp of K1's persistent loop).

Every kernel's bound is the larger of its f32 operations over 67 TFLOP/s
and its bytes over 3.35 TB/s (the H100's published peaks): operations
from the node pops and triangle tests its plain version counts on this
run's rays (``stats=True``), times the f32 operations of one pop and one
triangle test counted from the kernels' ``.cuh`` code (``OPS_*`` below);
bytes are the rays, the outputs and every node table the kernel reads,
each once, and one 64-byte record per real triangle (the 8-aligned leaf
padding is never read), at most one per triangle test.

K6's plan is bound the same way: object_ray and the bounds' 12 min/max
per ray and instance, the interval slab test per (tile, item)
(``OPS_PLAN_*``), the rays, page boxes and plan outputs as bytes.

Then one JSON line of the kernels, the card line, and the result line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero and
prints no result; without CUDA it exits 2 before importing the port.
The port runs without JAX: ``jax`` is blocked from being imported.
"""

import contextlib
import functools
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
# sampled rays against the brute cast: bench_paged.py's tolerance (the
# brute cast's plane-and-barycentric math is not the kernels' test_tri)
BRUTE_RTOL = 1e-5
# the pair's second camera: over the gap between the two instances,
# looking down, so that its rays hit both
PAIR_AERIAL_POSE = [18.0, 38.0, 30.0, 0.0, -1.2, 0.0]
# K4-K6 against K1 on the same scene: every difference must come from
# the order of box tests (traversal.unexplained_differences), and t may
# differ on at most this share of the rays (25 of 2,088,960 for K4 on
# the colonnade; 0-2 of 76,800 on a 156k-triangle colonnade on the CPU)
ORDER_DIFFS_MAX = 1e-4

# config 5 (bench_all.py:config_colonnade_path): the colonnade at its
# defaults (256,002 triangles) at 512x512, 2 samples and 2 bounces over a
# 5-pose fly-through, key k for frame k; the driver's path defaults (3
# bounces, 4 samples) are timed at 1920x1088; AO takes 8 samples
PATH_SIZE, PATH_SAMPLES, PATH_BOUNCES, FLY_FRAMES = 512, 2, 2, 5
AO_SAMPLES = 8
# (label, width, height, bounces, samples) of the path frames timed
PATH_TIMES = (("512x512", 512, 512, PATH_BOUNCES, PATH_SAMPLES),
              ("1920x1088", 1920, 1088, 3, 4))
# config5_colonnade_path_64 against the port: at most this many pixels
# differ (tests/test_torch_path.py GOLDEN5_MAX_MISMATCH; 9 of 4,096 on the
# CPU, bounce rays that directions a few ulps off send elsewhere)
GOLDEN5_MAX_MISMATCH = 16
# the shading slice's frames (phase 11c): 1920x1088, the SSAA frame at
# half that with 2x2 subpixels
SLICE_SIZE = (1920, 1088)

# The H100's published peaks (NVIDIA's data sheet, SXM, 700 W).
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# bytes written between timed launches to evict the card's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
# f32 operations of the kernels' per-ray code, counted from
# kernels/csrc/wide_traverse.cuh and paged_traverse.cuh (an add, multiply,
# divide, min, max or compare counts one):
#   child_entry, one child box: 6 subtracts + 6 multiplies, 6 fminf/fmaxf,
#   4 NaN-aware max/min, the cap multiply and 3 compares;
OPS_SLAB = 26
#   a pop of an arity-A node: A slab tests, the near-first rank (2
#   compares per ordered child pair) and the hit count;
OPS_POP = {A: OPS_SLAB * A + 2 * A * (A - 1) + A for A in (2, 4)}
#   a TLAS or top-tree pop: two slab tests and 3 compares;
OPS_TOP_POP = 2 * OPS_SLAB + 3
#   test_tri: denominator 5, c 3, numerator 5, divide 1, e2 6, u 5, v 5,
#   8 compares;
OPS_TRI = 38
#   object_ray, once per instance (or page-major item) and ray: two
#   quat_rot (42 each), 9 for the scale and offset, 3 safe reciprocals.
OPS_RAY = 2 * 42 + 9 + 9
# bytes of one triangle record (tri_rec row: 16 f32)
TRI_REC_BYTES = 64
# K6's plan (kernels/csrc/page_plan.cuh): per ray and instance object_ray
# and the 12 min/max of the tile bounds; per (tile, item) and axis the
# box's out-rounding 5, 4 subtracts, 8 products, 12 min/max of the
# products, 2 for the axis's near and far and 2 for their running max
# and min, then 3 compares and the key's min
OPS_PLAN_RAY = OPS_RAY + 12
OPS_PLAN_ITEM = 3 * (5 + 4 + 8 + 12 + 2 + 2) + 3 + 1


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
    """Kernel hit record against the plain version's, which visits each
    ray's nodes and triangles in the same order, so all three outputs
    must agree exactly: (t bit differences, max ulp, max abs error, tri
    differences, inst differences)."""
    return (int((hk.t.view(torch.int32) != hp.t.view(torch.int32)).sum()),
            int(ulp_distance(hk.t, hp.t).max()),
            float((hk.t.double() - hp.t.double()).abs().max()),
            int((hk.tri != hp.tri).sum()), int((hk.inst != hp.inst).sum()))


def device_ms(fn, kernel: str, n: int = 10) -> float:
    """Device milliseconds per call of ``fn`` spent in CUDA kernels whose
    name contains ``kernel``, from a ``torch.profiler`` trace of ``n``
    calls: the kernel's own time, without the host work around its
    launch (which the CUDA-event times of a call include whenever the
    host is slower than the card)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up: a first launch inside the profiler can go unrecorded
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if kernel in e.key)
        if us > 0:
            break
        phase("profiler_retry", kernel=kernel,
              seen=sorted({e.key[:60] for e in prof.key_averages()})[:8])
    check(us > 0, f"the profiler saw no device time in {kernel}")
    return us / n / 1e3


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
    from tpu_raytracer_torch.app.scenes import scene_bunny, scene_instances, scene_instances16
    from tpu_raytracer_torch.core.vecmath import FLT_MAX, normalize
    from tpu_raytracer_torch.kernels import build, tlas, traversal
    from tpu_raytracer_torch.kernels.wide4 import SHORT_STACK
    from tpu_raytracer_torch.render import (
        RenderConfig, generate_rays, hit_attributes, pipeline, render_image,
        render_image_whitted,
    )
    from tpu_raytracer_torch.render.camera import generate_rays_torch
    from tpu_raytracer_torch.render.integrators import _reflect
    from tpu_raytracer_torch.render.renderer import hit_attributes_torch
    from tpu_raytracer_torch.render.shade import (
        DEFAULT_LIGHT_DIRECTION, SHADOW_EPS, shade_primary_torch,
    )
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
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
    compiles = [ln for ln in log if ln.split(" ", 1)[0].endswith("nvcc") and " -c " in ln]
    report = build.ptxas_report(lib_path)
    # the short stack's ring is dynamic shared memory, sized at launch
    walk_kernels = (("wide_traverse_kernel<0>", "K1", False),
                    ("wide_traverse_kernel<1>", "K1", True),
                    ("binary_traverse_kernel<0>", "K2", False),
                    ("binary_traverse_kernel<1>", "K2", True),
                    ("tlas_traverse_kernel<0>", "K3", False),
                    ("tlas_traverse_kernel<1>", "K3", True),
                    ("paged_wide_kernel", "K4", False),
                    ("paged_binary_kernel", "K5", False),
                    ("paged_major_kernel", "K6", False))
    carry_kernels = (("wide_traverse_carry_kernel", "K1"), ("tlas_traverse_carry_kernel", "K3"))
    dyn = {kernel: traversal.launch_shape(k, occ, 1)["shared_bytes"]
           for kernel, k, occ in walk_kernels}
    dyn.update({kernel: traversal.launch_shape(k, False, 1, carry=True)["shared_bytes"]
                for kernel, k in carry_kernels})
    for kernel, r in report.items():
        r["shared_dynamic"] = dyn.get(kernel, 0)
    phase("build", kernels="K1/K2+K3+K4/K5+K6+K6 plan+S1/S2/S3/S4/S5/S6", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=lib_path.name, commands=repr(compiles),
          ptxas=json.dumps(report, separators=(",", ":")))
    for src in build.CUDA_SOURCES:
        check(any(ln.endswith(src) and "code=sm_90a" in ln and "--fmad=false" in ln
                  for ln in compiles), f"{src} was not built for sm_90a with --fmad=false")
    built = [k for k, _, _ in walk_kernels] + [k for k, _ in carry_kernels] + [
        f"page_plan_{k}_kernel" for k in ("init", "tiles", "order", "lists")] + list(
        FRAME_KERNEL_NAMES.values())
    check(all(kernel in report for kernel in built),
          f"ptxas reported no {[k for k in built if k not in report]}")

    design = {f"{k}{'_any_hit' if occ else ''}": traversal.launch_shape(k, occ, 1920 * 1088)
              for _, k, occ in walk_kernels}
    design.update({f"{k}_carry": traversal.launch_shape(k, False, 1920 * 1088, carry=True)
                   for _, k in carry_kernels})
    phase("walk_design", kernels="K1,K2,K3,K4,K5,K6", walk="kernels/csrc/walk.cuh",
          short_stack=SHORT_STACK, persistent_warps="K1-K5; K6 one block per tile",
          node_records="8A f32 lanes: 6A box floats, A codes bit-cast (K1/K3 wnode [W,32], "
                       "K2 binary node [N,16], K4/K6 page node [N,32], K5 page node [N,16])",
          launch_1920x1088=json.dumps(design, separators=(",", ":")))

    # 3. K1 against the plain version on the flagship -------------------
    t0 = time.perf_counter()
    scene, cam = scene_bunny(1920, 1088, device=dev)
    phase("scene", triangles=scene.num_triangles, wide_nodes=scene.wide4.wcode.shape[0],
          wide_depth=scene.wide4.depth, max_leaf=scene.wide4.max_leaf,
          build_s=f"{time.perf_counter() - t0:.2f}")
    p = cam.ray_params(dev)
    # the plain rays (S1's plain version): K1 and its plain walk take them,
    # and [main_path]'s plain frame starts from them
    origin, dirs = generate_rays_torch(cam.width, cam.height, p["K_inv"], p["D"],
                                       p["pose"], p["inv_pose"])
    hk = traversal.cast_rays_cuda(scene, origin, dirs)
    hp, k1_stats = traversal.cast_rays_wide_torch(scene, origin, dirs, stats=True)
    torch.cuda.synchronize()
    n_t, max_ulp, max_abs, n_tri, n_inst = compare_hits(hk, hp)
    hit_frac = float((hk.tri >= 0).float().mean())
    phase("k1_vs_plain", rays=hk.t.numel(), t_bitwise_diff=n_t, max_ulp=max_ulp,
          max_abs_err=max_abs, tri_diff=n_tri, inst_diff=n_inst,
          hit_fraction=f"{hit_frac:.4f}")
    check(max_ulp <= T_MAX_ULP, f"K1 t differs from the plain walk by {max_ulp} ulp")
    check(n_tri == 0 and n_inst == 0, "K1 tri/inst differ from the plain walk")
    check(abs(hit_frac - FLAGSHIP_HIT_FRACTION) <= HIT_FRACTION_TOL,
          f"hit fraction {hit_frac:.4f} vs {FLAGSHIP_HIT_FRACTION}")

    # 4. main path ------------------------------------------------------
    config = RenderConfig(cam.width, cam.height, backend="cuda")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    build.reset_launches()
    img = render_image(config, scene, *args)
    torch.cuda.synchronize()
    launches = build.LAUNCHES["K1"]
    stage_launches = _stage_counts()
    # the frame through plain versions alone: S1's, K1's, S2's and S3's
    img_plain = shade_primary_torch(scene, hit_attributes_torch(scene, origin, dirs, hp))
    n_img = int((img != img_plain).any(-1).sum())
    img_np = img.cpu().numpy()
    sky = np.array([255, 204, 153], np.uint8)
    img_hit_frac = float((img_np != sky).any(-1).mean())
    phase("main_path", shape=tuple(img.shape), dtype=img.dtype, k1_launches=launches,
          stage_launches=stage_launches, pixels_vs_plain=n_img,
          image_hit_fraction=f"{img_hit_frac:.4f}")
    check(launches >= 1, "render_image did not launch K1")
    check({k: v for k, v in stage_launches.items() if v} == {"S1": 1, "S2": 1, "S3": 1},
          f"render_image launched the frame stages {stage_launches}, not S1-S3 once each")
    check(img.shape == (1088, 1920, 3) and img.dtype == torch.uint8, "bad image")
    check(n_img == 0, f"{n_img} pixels differ from the plain path")

    # 5. config 1 against the CPU goldens -------------------------------
    goldens = golden_renders(dev)
    mism1 = _golden_mismatch(goldens["config1_cube_64"](), "config1_cube_64")
    mism2 = _golden_mismatch(goldens["cube_64"](), "cube_64")
    phase("golden", config1_cube_64_mismatch=mism1, cube_64_mismatch=mism2)
    check(max(mism1, mism2) <= GOLDEN_MAX_MISMATCH,
          f"golden mismatch {mism1}/{mism2} pixels (nearest-texel flips at "
          "checker boundaries allow at most 4)")
    frame_entries = frame_kernels_phase(dev, card, stage_launches)
    frame_entries += sample_kernel_phase(dev, card, scene, origin, dirs, args)
    frame_entries += whitted_shade_phase(dev, card)

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
    k3_stats = {}
    for tag, (sc, ro, rd) in k3_sets.items():
        hk3 = tlas.cast_rays_tlas_cuda(sc, ro, rd, carry=False)
        hp3, k3_stats[tag] = tlas.cast_rays_tlas_torch(sc, ro, rd, stats=True)
        torch.cuda.synchronize()
        n_t, max_ulp, max_abs, n_tri, n_inst = compare_hits(hk3, hp3)
        k3_max_abs = max(k3_max_abs, max_abs)
        phase("k3_vs_plain", rays=tag, n=hk3.t.numel(), instances=sc.num_instances,
              tlas_nodes=sc.tlas.code.shape[0], tlas_depth=sc.tlas.depth,
              t_bitwise_diff=n_t, max_ulp=max_ulp, max_abs_err=max_abs,
              tri_diff=n_tri, inst_diff=n_inst,
              hit_fraction=f"{float((hk3.tri >= 0).float().mean()):.4f}")
        check(n_t == 0, f"K3 t differs from the plain walk on {tag}")
        check(n_tri == 0 and n_inst == 0, f"K3 tri/inst differ from the plain walk on {tag}")

    # 7. any hit --------------------------------------------------------
    ldir = normalize(torch.tensor(DEFAULT_LIGHT_DIRECTION, dtype=torch.float32, device=dev))

    def shadow_rays(sc, ro, rd, h):
        at = hit_attributes(sc, ro, rd, h)
        return park_dead_rays(at.location + ldir * SHADOW_EPS, ldir.expand(at.location.shape),
                              at.hit)

    shadow1 = shadow_rays(scene, origin, dirs, hk)
    shadow4 = shadow_rays(inst4, o4, d4, h4)
    occ_err, occ_stats = {}, {}
    for tag, sc, rays, cast, plain in (
        ("K1_flagship", scene, shadow1, traversal.cast_rays_cuda, traversal.cast_rays_wide_torch),
        ("K3_config4", inst4, shadow4, tlas.cast_rays_tlas_cuda, tlas.cast_rays_tlas_torch),
    ):
        occ = cast(sc, *rays, occlusion=True)
        near = cast(sc, *rays)
        plain_occ, occ_stats[tag] = plain(sc, *rays, occlusion=True, stats=True)
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
    build.reset_launches()
    img_sh = render_image(shadow_cfg, scene, *args)
    torch.cuda.synchronize()
    k1_shadow_launches = build.LAUNCHES["K1"]
    # the primary cast carries the normal (K1's carrying kernel), the
    # shadow cast is K1's any hit
    k1_any_launches = k1_shadow_launches - build.LAUNCHES["K1_carry"]
    phase("shadow_path", scene="flagship", lighting="lambert_shadow",
          k1_launches=k1_shadow_launches, k1_carry_launches=build.LAUNCHES["K1_carry"],
          lit_differs_from_flat=int((img_sh != img).any(-1).sum()))
    check(k1_shadow_launches == 2 and k1_any_launches == 1,
          "the shadowed flagship frame did not launch K1 twice, once in any-hit mode")

    # 8. Whitted main path ----------------------------------------------
    wcfg = RenderConfig(cam4.width, cam4.height, backend="cuda")
    build.reset_launches()
    img_w = render_image_whitted(wcfg, inst4, *args4)
    torch.cuda.synchronize()
    k3_launches = build.LAUNCHES["K3"]
    k3_carry_launches = build.LAUNCHES["K3_carry"]
    k1_in_whitted = build.LAUNCHES["K1"]
    saved_cast = traversal.cast_rays
    traversal.cast_rays = _plain_router(traversal, tlas)
    img_w_plain = render_image_whitted(wcfg, inst4, *args4)
    traversal.cast_rays = saved_cast
    n_w = int((img_w != img_w_plain).any(-1).sum())
    phase("whitted", scene="config4", shape=tuple(img_w.shape), k3_launches=k3_launches,
          k3_carry_launches=k3_carry_launches,
          k1_launches=k1_in_whitted, pixels_vs_plain=n_w,
          image_mean=f"{float(img_w.float().mean()):.3f}")
    # 3 nearest casts (primary + 2 bounces) and 3 any-hit shadow casts
    check(k3_launches == 6, f"the Whitted frame launched K3 {k3_launches} times, not 6")
    # the nearest casts carry u, v (textured floor) and n; the shadow casts do not
    check(k3_carry_launches == 3, f"the Whitted frame's nearest casts did not carry "
          f"({k3_carry_launches} carrying launches, not 3)")
    check(n_w == 0, f"{n_w} Whitted pixels differ from the plain casts' image")

    # 9. configs 2-4 against the CPU goldens ----------------------------
    mism = {g: _golden_mismatch(goldens[g](), g) for g in (
        "config2_cornell_64", "config3_bunny_96", "config4_instances_whitted_64")}
    phase("golden2", **{f"{k}_mismatch": v for k, v in mism.items()})
    check(max(mism.values()) <= GOLDEN_MAX_MISMATCH,
          f"golden mismatch {mism} (at most {GOLDEN_MAX_MISMATCH} pixels each)")

    # 10. demo driver ---------------------------------------------------
    # its frames replay one CUDA graph (the compiled render_image), whose
    # capture records the launches of a replay; the counters move in the
    # warm-up frame and the capture
    pipeline.clear_compiled()
    build.reset_launches()
    demo = driver.run("demo", 1920, 1088, frames=3,
                      out=os.path.join(tempfile.mkdtemp(), "demo.png"), device="cuda")
    demo_launches = build.LAUNCHES["K3"]
    demo_entry = pipeline.compiled_render_image.last
    phase("demo", shape=tuple(demo.shape), k3_launches=demo_launches,
          k3_per_replay=demo_entry.launches.get("K3"), replays=demo_entry.replays,
          entries=len(pipeline.compiled_render_image.entries),
          image_hit_fraction=f"{float((demo.numpy() != sky).any(-1).mean()):.4f}")
    check(demo_launches >= 1 and demo_entry.launches.get("K3") == 1
          and demo_entry.replays == 3 and len(pipeline.compiled_render_image.entries) == 1,
          "the demo driver did not replay one graph launching K3 once per frame")
    pipeline.clear_compiled()

    # 11. time ----------------------------------------------------------
    cast = lambda: traversal.cast_rays_cuda(scene, origin, dirs)
    cast()
    cast_ms = min(event_ms(cast, 10) for _ in range(5))
    k1_kernel_ms = device_ms(cast, "wide_traverse_kernel")
    plain_ms = event_ms(lambda: traversal.cast_rays_wide_torch(scene, origin, dirs), 1)
    rays = cam.width * cam.height
    phase("time", card=repr(card), k1_cast_ms=f"{cast_ms:.4f}",
          k1_kernel_ms=f"{k1_kernel_ms:.4f}",
          k1_mrays_s=f"{rays / cast_ms / 1e3:.2f}", plain_cast_ms=f"{plain_ms:.2f}")

    k1_any = lambda: traversal.cast_rays_cuda(scene, *shadow1, occlusion=True)
    k3_cast = lambda: tlas.cast_rays_tlas_cuda(inst4, o4, d4, carry=False)
    for fn in (k1_any, k3_cast):
        fn()
    k1_any_ms = min(event_ms(k1_any, 10) for _ in range(5))
    k3_ms = min(event_ms(k3_cast, 10) for _ in range(5))
    k1_any_kernel_ms = device_ms(k1_any, "wide_traverse_kernel")
    k3_kernel_ms = device_ms(k3_cast, "tlas_traverse_kernel")
    # K3 on each kind of ray the Whitted frame casts: primary, reflection
    # (nearest) and shadow (any hit), each with its bound
    t4 = inst4.tlas
    k3_tables = (inst4.wide4.wnode, t4.code, t4.box)
    k3_frame_sets = {
        "primary": ((o4, d4), False, k3_stats["config4_primary"]),
        "reflection": (refl4, False, k3_stats["config4_reflection"]),
        "shadow": (shadow4, True, occ_stats["K3_config4"]),
    }
    k3_per_set = {}
    for tag, (rays4, occ4, st4) in k3_frame_sets.items():
        fn = lambda rays4=rays4, occ4=occ4: tlas.cast_rays_tlas_cuda(inst4, *rays4,
                                                                     occlusion=occ4, carry=False)
        fn()
        ms4 = device_ms(fn, "tlas_traverse_kernel")
        n4 = rays4[1].numel() // 3
        b4 = bound(f"K3 config4 {tag}", st4, 4, n4, (*rays4, *k3_tables, *h4[:3]),
                   real_tri_rows(inst4))
        k3_per_set[tag] = {"ms": ms4, **b4}
        phase("time_k3", card=repr(card), rays=f"config4_{tag}", n=n4, any_hit=occ4,
              kernel_ms=f"{ms4:.4f}", bound_ms=f"{b4['bound_ms']:.4f}",
              share_of_bound=f"{b4['bound_ms'] / ms4:.4f}")
    k1_any_plain_ms = event_ms(
        lambda: traversal.cast_rays_wide_torch(scene, *shadow1, occlusion=True), 1)
    k3_plain_ms = event_ms(lambda: tlas.cast_rays_tlas_torch(inst4, o4, d4), 1)
    phase("time2", card=repr(card), k3_cast_ms=f"{k3_ms:.4f}",
          k3_kernel_ms=f"{k3_kernel_ms:.4f}", k1_any_hit_kernel_ms=f"{k1_any_kernel_ms:.4f}",
          k3_mrays_s=f"{d4.numel() // 3 / k3_ms / 1e3:.2f}",
          k3_plain_ms=f"{k3_plain_ms:.2f}", k1_any_hit_ms=f"{k1_any_ms:.4f}",
          k1_any_hit_plain_ms=f"{k1_any_plain_ms:.2f}")
    carry_entries = carry_phases(dev, card, report, (scene, origin, dirs, args),
                                 (inst4, o4, d4, refl4, cam4), goldens)

    paged_kernels, paged_ctx = paged_phases(dev, card)
    k2_entries, path_ctx = path_phases(dev, card, (scene, origin, dirs), shadow1)
    frame_entries += path_bounce_phase(dev, card, path_ctx)
    ao_bound_phase(dev, card)
    flatten_phases(dev, card, (inst4, o4, d4, args4, img_w, k3_per_set),
                   (inst16, cam16, o16, d16))
    presplit_phase(dev, card, paged_ctx)
    big_entry = big_scene_phase(dev, card, paged_ctx)
    optimize_phase(dev, card, path_ctx)
    scene_io_phases(dev, path_ctx)
    shard_phases(dev, card, (scene, args), (inst4, args4), paged_ctx, path_ctx)
    graph_phase(dev, card, (scene, args), (inst4, args4), paged_ctx, path_ctx)
    app_phases(dev, card)

    wide = scene.wide4
    k1_bound = bound("K1", k1_stats, 4, rays, (dirs, origin, wide.wnode, *hk[:3]),
                     real_tri_rows(scene))
    k1_any_bound = bound("K1 any-hit", occ_stats["K1_flagship"], 4, shadow1[1].numel() // 3,
                         (*shadow1, wide.wnode, *hk[:3]), real_tri_rows(scene))
    k3_bound = {k: v for k, v in k3_per_set["primary"].items() if k != "ms"}
    check("jax" not in sys.modules or sys.modules["jax"] is None, "jax was imported")
    print(json.dumps({"kernels": [
        {
            "name": "K1 wide_traverse (4-wide BVH nearest hit; launches: the flagship frame)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
            "replaces": "tpu_raytracer/kernels/dual.py:147",
            "launches": launches,
            "max_abs_err": max_abs,
            "ms": k1_kernel_ms,
            "plain_ms": plain_ms,
            **k1_bound,
        },
        {
            "name": "K1 wide_traverse any-hit mode (shadow rays; launches: the shadowed "
                    "flagship frame's shadow cast, its primary cast being K1's carrying "
                    "kernel; bound from the nearest-hit walk's counts, more than the any-hit "
                    "walk does)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
            "replaces": "tpu_raytracer/kernels/dual.py:147",
            "launches": k1_any_launches,
            "max_abs_err": occ_err["K1_flagship"],
            "ms": k1_any_kernel_ms,
            "plain_ms": k1_any_plain_ms,
            **k1_any_bound,
        },
        {
            "name": "K3 tlas_traverse (TLAS + 4-wide BLAS, nearest and any hit; launches: "
                    "the config 4 Whitted frame's casts without the carry, its 3 shadow "
                    "casts; ms and bound: config 4 primary rays, nearest hit; "
                    "reflection " + ", shadow ".join(
                        f"{k3_per_set[k]['ms']:.4f} ms, bound {k3_per_set[k]['bound_ms']:.4f} ms"
                        for k in ("reflection", "shadow")) + ")",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/tlas_traverse.cu",
            "replaces": "tpu_raytracer/kernels/tlas.py:176",
            "launches": k3_launches - k3_carry_launches,
            "max_abs_err": max(k3_max_abs, occ_err["K3_config4"]),
            "ms": k3_kernel_ms,
            "plain_ms": k3_plain_ms,
            **k3_bound,
        },
        *carry_entries,
        *k2_entries,
        *paged_kernels,
        big_entry,
        *frame_entries,
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _pixels(a, b) -> int:
    """Pixels where two frames differ: u8 images, or AOV dicts (any buffer,
    floats bit for bit)."""
    if isinstance(a, dict):
        off = torch.zeros(a["hit"].shape, dtype=torch.bool, device=a["hit"].device)
        for k in a:
            x, y = a[k], b[k]
            x, y = (_bits(x), _bits(y)) if x.dtype == torch.float32 else (x, y)
            diff = x != y
            off |= diff.any(-1) if diff.dim() > off.dim() else diff
        return int(off.sum())
    return int((a != b).any(-1).sum())


@contextlib.contextmanager
def carry_off():
    """The ``cuda`` backend with the carry of K1 and K3 off."""
    from tpu_raytracer_torch.kernels import traversal

    saved = traversal.cast_rays
    traversal.cast_rays = functools.partial(saved, carry=False)
    try:
        yield
    finally:
        traversal.cast_rays = saved


def carry_phases(dev, card, report, flagship, config4, goldens) -> list:
    """Phases 11b-11d: the carrying kernels of K1 and K3 against their
    plain versions (``[carry]``), the shading slice's frames
    (``[shade_slice]``) and the goldens with the carry on and off
    (``[golden_carry]``); returns the carrying kernels' entries of the
    kernels line. ``flagship`` is (scene, origin, dirs, camera args) of
    phase 3, ``config4`` (scene, origin, dirs, reflection rays, camera)
    of phase 6, ``goldens`` ``golden_renders``."""
    from tpu_raytracer_torch.app.scenes import build_demo_scene, scene_cube
    from tpu_raytracer_torch.kernels import build, tlas, traversal
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, reference_calibration,
        render_aovs, render_image, render_image_whitted,
    )
    from tpu_raytracer_torch.render.integrators import PointLight
    from tpu_raytracer_torch.scene import procgen

    scene, origin, dirs, args = flagship
    inst4, o4, d4, refl4, cam4 = config4
    W, H = SLICE_SIZE

    def params(cam):
        p = cam.ray_params(dev)
        return p["K_inv"], p["D"], p["pose"], p["inv_pose"]

    # 11b. the carrying kernels against their plain versions -----------
    cube, cube_cam = scene_cube(64, device=dev)
    oc, dc = generate_rays(W, H, *params(
        Camera.looking(W, H, fov_deg=45.0, pose=cube_cam.pose)))
    sets = {"K1_flagship_primary": ("K1", scene, origin, dirs),
            "K1_cube_primary": ("K1", cube, oc, dc),
            "K3_config4_primary": ("K3", inst4, o4, d4),
            "K3_config4_reflection": ("K3", inst4, *refl4)}
    res = {}
    for tag, (k, sc, ro, rd) in sets.items():
        cast = traversal.cast_rays_cuda if k == "K1" else tlas.cast_rays_tlas_cuda
        plain = traversal.cast_rays_wide_torch if k == "K1" else tlas.cast_rays_tlas_torch
        name = "wide_traverse" if k == "K1" else "tlas_traverse"
        uv, n = traversal.carry_fields(sc, rd, False, True, True)
        hk = cast(sc, ro, rd, want_normals=True, carry=True)
        hp, stats = plain(sc, ro, rd, stats=True, carry_uv=uv, carry_n=n)
        torch.cuda.synchronize()
        diff = {}
        for field, a, b in zip(hk._fields, hk, hp):
            check((a is None) == (b is None), f"{k} carried {field} where its plain version "
                  "did not, or the other way")
            if a is not None:
                diff[field] = int((_bits(a) != _bits(b)).sum()) if a.is_floating_point() \
                    else int((a != b).sum())
        carry_fn = lambda sc=sc, ro=ro, rd=rd, cast=cast: cast(sc, ro, rd, want_normals=True,
                                                               carry=True)
        bare_fn = lambda sc=sc, ro=ro, rd=rd, cast=cast: cast(sc, ro, rd, carry=False)
        carry_ms = device_ms(carry_fn, f"{name}_carry_kernel")
        bare_ms = device_ms(bare_fn, f"{name}_kernel")
        plain_ms = event_ms(lambda sc=sc, ro=ro, rd=rd, plain=plain: plain(
            sc, ro, rd, carry_uv=uv, carry_n=n), 1)
        tables = (sc.wide4.wnode,) + ((sc.tlas.code, sc.tlas.box) if k == "K3" else ())
        n_rays = rd.numel() // 3
        b = bound(f"{k} carry {tag}", stats, 4, n_rays,
                  (ro, rd, *tables, *(x for x in hk if x is not None)), real_tri_rows(sc))
        res[tag] = {"ms": carry_ms, "plain_ms": plain_ms, "bound": b}
        phase("carry", card=repr(card), kernel=k, rays=tag, n=n_rays, carry_uv=uv, carry_n=n,
              **{f"{f}_bitwise_diff": v for f, v in diff.items()},
              kernel_ms_carry=f"{carry_ms:.4f}", kernel_ms_no_carry=f"{bare_ms:.4f}",
              carry_cost=f"{carry_ms / bare_ms - 1.0:+.4f}",
              bound_ms=f"{b['bound_ms']:.4f}", share_of_bound=f"{b['bound_ms'] / carry_ms:.4f}",
              plain_ms=f"{plain_ms:.2f}",
              hit_fraction=f"{float((hk.tri >= 0).float().mean()):.4f}")
        check(not any(diff.values()), f"{k}'s carrying kernel differs from its plain version "
              f"on {tag}: {diff}")
    phase("carry_build", **{kernel: json.dumps(report[kernel], separators=(",", ":"))
                            for kernel in ("wide_traverse_kernel<0>", "wide_traverse_carry_kernel",
                                           "tlas_traverse_kernel<0>",
                                           "tlas_traverse_carry_kernel")})

    # 11c. the shading slice's frames ------------------------------------
    light = (PointLight((0.0, 2.0, 2.0), 4.0),)  # over config 4's floor
    demo = build_demo_scene()
    demo.set_sky(procgen.sky_gradient_texture())
    demo = demo.compile(dev)
    K, D = reference_calibration(W, H)
    demo_cam = Camera(W, H, K, D, pose=np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32))
    demo_args = params(demo_cam)
    args4 = params(cam4)
    args_half = params(Camera.looking(W // 2, H // 2, fov_deg=60.0, pose=cam4.pose))
    frames = {
        "config3_blinn_phong": (scene, args, "reference", lambda: render_image(
            RenderConfig(W, H, lighting="blinn_phong"), scene, *args)),
        "config4_whitted_point_light": (inst4, args4, "reference", lambda: render_image_whitted(
            RenderConfig(W, H, point_lights=light), inst4, *args4)),
        "config4_whitted_point_light_inverse_transpose": (
            inst4, args4, "inverse_transpose", lambda: render_image_whitted(
                RenderConfig(W, H, point_lights=light, normal_mode="inverse_transpose"),
                inst4, *args4)),
        "demo_sky_gradient_trilinear": (demo, demo_args, "reference", lambda: render_image(
            RenderConfig(W, H, texture_filter="trilinear"), demo, *demo_args)),
        "config4_aovs": (inst4, args4, "reference", lambda: render_aovs(
            RenderConfig(W, H), inst4, *args4)),
        f"config4_whitted_ssaa2_{W // 2}x{H // 2}": (
            inst4, args4, "reference", lambda: render_image_whitted(
                RenderConfig(W // 2, H // 2, ssaa=2), inst4, *args_half)),
    }
    slice_launches = {"K1": 0, "K3": 0}
    for tag, (sc, fargs, normal_mode, fn) in frames.items():
        build.reset_launches()
        img = fn()
        torch.cuda.synchronize()
        n = {k: build.LAUNCHES[k] for k in ("K1", "K1_carry", "K3", "K3_carry")}
        with plain_casts():
            n_plain = _pixels(img, fn())
        with carry_off():
            img_off = fn()
        n_off = _pixels(img, img_off)
        fn()
        best, median = best_and_median_ms(fn, loops=3, n=3)
        # hit_attributes of the frame's primary cast, carried and redone
        ro, rd = generate_rays(W, H, *fargs)
        h_on = traversal.cast_rays(sc, ro, rd, want_normals=True)
        h_off = traversal.cast_rays(sc, ro, rd, carry=False)
        # in turns (on, off, off, on, ...): the eager stage is host-bound
        attrs_ms = {"on": float("inf"), "off": float("inf")}
        for which in ("on", "off", "off", "on") * 2:
            h = h_on if which == "on" else h_off
            attrs_ms[which] = min(attrs_ms[which], event_ms(
                lambda h=h: hit_attributes(sc, ro, rd, h, normal_mode=normal_mode), 10))
        phase("shade_slice", card=repr(card), frame=tag, launches=json.dumps(n),
              frame_ms_best=f"{best:.4f}", frame_ms_median=f"{median:.4f}",
              attrs_ms_carry_on=f"{attrs_ms['on']:.4f}",
              attrs_ms_carry_off=f"{attrs_ms['off']:.4f}", pixels_vs_plain=n_plain,
              pixels_vs_carry_off=n_off)
        check(n["K1_carry"] + n["K3_carry"] >= 1, f"the {tag} frame launched no carrying kernel")
        check(n_plain == 0, f"{n_plain} pixels of the {tag} frame differ from the plain casts'")
        if tag == "config3_blinn_phong":
            slice_launches["K1"] = n["K1_carry"]
        if tag == "config4_whitted_point_light":
            slice_launches["K3"] = n["K3_carry"]

    # 11d. the goldens with the carry on and off --------------------------
    mism = {}
    for gname, fn in goldens.items():
        on = fn()
        with carry_off():
            off = fn()
        mism[gname] = (_golden_mismatch(on, gname), _golden_mismatch(off, gname),
                       _pixels(on, off))
    phase("golden_carry", **{f"{g}_on/off/on_vs_off": "/".join(map(str, v))
                             for g, v in mism.items()})
    for g, (on, _, _) in mism.items():
        check(on <= GOLDEN_MAX_MISMATCH, f"{g}: {on} pixels off the golden with the carry on "
              f"(at most {GOLDEN_MAX_MISMATCH})")

    def entry(k, tag, what):
        r = res[tag]
        return {
            "name": f"{k} {'wide' if k == 'K1' else 'tlas'}_traverse_carry_kernel ({what})",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/"
                      + ("wide_traverse.cu" if k == "K1" else "tlas_traverse.cu"),
            "replaces": "tpu_raytracer/kernels/traversal.py:145",
            "launches": slice_launches[k],
            "max_abs_err": 0.0,
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            **r["bound"],
        }

    return [
        entry("K1", "K1_flagship_primary",
              "K1 with make_test_tri's carry_n: the accepted triangle's face normal; "
              "launches: the config 3 Blinn-Phong frame; ms, bound: the flagship's primary "
              f"rays; on the cube's 1920x1088 rays (u, v and n) "
              f"{res['K1_cube_primary']['ms']:.4f} ms, bound "
              f"{res['K1_cube_primary']['bound']['bound_ms']:.4f} ms"),
        entry("K3", "K3_config4_primary",
              "K3 with make_test_tri's carry_uv and carry_n; launches: the config 4 Whitted "
              "frame with a point light; ms, bound: config 4 primary rays; reflection rays "
              f"{res['K3_config4_reflection']['ms']:.4f} ms, bound "
              f"{res['K3_config4_reflection']['bound']['bound_ms']:.4f} ms"),
    ]


def real_tri_rows(scene) -> int:
    """Triangle records the leaves own: the scene's triangles without the
    8-aligned leaf padding, which no walk reads."""
    return int(scene.node_leaf_count[scene.node_child_a < 0].sum())


def bound(tag, counters, arity, n_rays, tensors, tri_rows):
    """The kernel's bound on this run's rays: the larger of its f32
    operations (from the plain version's visit counters) over the card's
    f32 rate and its bytes over its memory rate: ``tensors`` (rays, node
    tables, outputs, each read or written once) and the records of
    ``tri_rows`` real triangles, at most one per triangle test. Prints
    the counts."""
    pops, top, tests = (int(counters[k].sum()) for k in ("pops", "top_pops", "tests"))
    ops = pops * OPS_POP[arity] + top * OPS_TOP_POP + tests * OPS_TRI
    ops += n_rays * OPS_RAY
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += min(tri_rows, tests) * TRI_REC_BYTES
    t_ops, t_bytes = ops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    phase("bound", kernel=tag, rays=n_rays, pops=pops, top_pops=top, tests=tests,
          tri_rows=tri_rows,
          pops_per_ray=f"{pops / n_rays:.3f}", tests_per_ray=f"{tests / n_rays:.3f}",
          gflop=f"{ops / 1e9:.4f}", mbytes=f"{nbytes / 1e6:.3f}", ops_ms=f"{t_ops:.6f}",
          bytes_ms=f"{t_bytes:.6f}", bound_by=by)
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by, "library_ms": None}


def timed(fn):
    """(result, milliseconds) of one call, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def brute_unexplained(scene, origin, dirs, hit, brute):
    """(rays whose t is not within BRUTE_RTOL of the brute cast's, those
    of them not explained by box culling): the brute cast tests every
    triangle, so it also finds the hits that lie up to EDGE_EPS outside
    a triangle and outside its leaf box, which a walk may cull
    (``traversal.unexplained_differences``)."""
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.render import Hit

    far = ~torch.isclose(hit.t, brute.t, rtol=BRUTE_RTOL, atol=BRUTE_RTOL)
    sub = lambda h: Hit(*(x[far] for x in h[:3]))
    return int(far.sum()), traversal.unexplained_differences(
        scene, origin.expand(dirs.shape)[far], dirs[far], sub(hit), sub(brute))


def plan_vs_plain(scene, origin, dirs, tag) -> dict:
    """K6's plan from the card against the plain plan on rays in tile
    order: the seen items in the same order, the unseen ones after them,
    every tile's list bitwise; prints ``[plan_vs_plain]`` and returns the
    plan's bound."""
    from tpu_raytracer_torch.kernels import paged_major

    pid, iid, mask = paged_major.page_major_plan(scene, origin, dirs)
    start, items = paged_major.tile_lists(mask)
    c_pid, c_iid, c_start, c_items = paged_major.page_major_plan_cuda(scene, origin, dirs)
    torch.cuda.synchronize()
    n, k = pid.shape[0], c_pid.shape[0]
    order_diff = int((c_pid[:n] != pid).sum() + (c_iid[:n] != iid).sum())
    start_diff = int((c_start != start).sum())
    nnz = int(start[-1])
    item_diff = int((c_items[:nnz] != items).sum()) if start_diff == 0 else -1
    tiles, r = start.shape[0] - 1, dirs.shape[0]
    phase("plan_vs_plain", rays=tag, n=r, tiles=tiles, items=k, items_seen=n,
          list_entries=nnz, item_order_diff=order_diff, tile_start_diff=start_diff,
          tile_item_diff=item_diff)
    check(order_diff == 0 and start_diff == 0 and item_diff == 0,
          f"K6's card plan differs from the plain plan on {tag}")
    check(torch.equal(torch.sort(c_iid.long() * scene.paged.num_pages + c_pid.long()).values,
                      torch.arange(k, device=c_pid.device)), "the card plan lost an item")
    ops = (r * scene.num_instances * OPS_PLAN_RAY + tiles * k * OPS_PLAN_ITEM)
    nbytes = (origin.numel() + dirs.numel()) * 4 + scene.num_instances * 12 * 4
    nbytes += scene.paged.num_pages * (2 * 3 * 4 + 4) + (2 * k + tiles + 1 + nnz) * 4
    t_ops, t_bytes = ops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    phase("bound", kernel=f"K6 plan {tag}", rays=r, tiles=tiles, items=k,
          gflop=f"{ops / 1e9:.4f}", mbytes=f"{nbytes / 1e6:.3f}", ops_ms=f"{t_ops:.6f}",
          bytes_ms=f"{t_bytes:.6f}", bound_by=by)
    return {"max_abs": 0.0,
            "bound": {"bound_ms": max(t_ops, t_bytes), "bound_by": by, "library_ms": None}}


def paged_phases(dev, card) -> tuple:
    """Phases 12-17: the colonnade through the paged kernels; returns
    their entries of the kernels line, and the colonnade, its rays and
    results for ``presplit_phase``."""
    from tpu_raytracer_torch.app.scenes import scene_colonnade, scene_colonnade_pair
    from tpu_raytracer_torch.kernels import build, paged, paged_major, traversal
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, render_image, shade_primary,
    )
    from tpu_raytracer_torch.render.renderer import cast_rays_brute

    # 12. host build ----------------------------------------------------
    t0 = time.perf_counter()
    col, cam = scene_colonnade(1920, 1088, columns=18, segs=40, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide_sc = col.with_paging()
    wide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bin_sc = col.with_paging(wide=False)
    bin_s = time.perf_counter() - t0
    pw, pb = wide_sc.paged, bin_sc.paged
    mb = lambda *ts: f"{sum(t.numel() * t.element_size() for t in ts) / 1e6:.2f}"
    col_rows = real_tri_rows(col)
    phase("colonnade", triangles=col.num_triangles, real_triangles=col_rows, bvh_nodes=col.node_child_a.shape[0],
          wide_nodes=col.wide4.wcode.shape[0], wide_depth=col.wide4.depth,
          host_build_s=f"{build_s:.2f}", paging_wide_s=f"{wide_s:.2f}",
          paging_binary_s=f"{bin_s:.2f}", pages=pw.num_pages, top_nodes=pw.top_code.shape[0],
          top_depth=pw.top_depth, page_nodes_wide=pw.code.shape[0], page_depth_wide=pw.depth,
          page_nodes_binary=pb.code.shape[0], page_depth_binary=pb.depth,
          binary_nodes=col.binary.code.shape[0], binary_depth=col.binary.depth,
          tri_rec_mb=mb(col.wide4.tri_rec), k1_tables_mb=mb(col.wide4.wnode),
          k4_tables_mb=mb(pw.node, pw.top_code, pw.top_box),
          k5_tables_mb=mb(pb.node, pb.top_code, pb.top_box), k6_tables_mb=mb(pw.node))
    check(col_rows > 1_000_000, "the colonnade has fewer than 1M triangles")
    check(build_s < 120, f"the colonnade's host build took {build_s:.1f} s")

    # 13. K4, K5, K6 against their plain versions and K1 ----------------
    p = cam.ray_params(dev)
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = generate_rays(cam.width, cam.height, *args)
    n_rays = d.numel() // 3
    k1 = traversal.cast_rays_cuda(col, o, d)
    cases = {
        "K4": (wide_sc, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch, 4),
        "K5": (bin_sc, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch, 2),
        "K6": (wide_sc, paged_major.cast_rays_paged_major_cuda,
               paged_major.cast_rays_paged_major_torch, 4),
    }
    res = {}
    for k, (sc, cast, plain, arity) in cases.items():
        hk = cast(sc, o, d)
        torch.cuda.synchronize()
        (hp, counters), plain_ms = timed(lambda: plain(sc, o, d, stats=True))
        n_t, max_ulp, max_abs, n_tri, n_inst = compare_hits(hk, hp)
        t_vs_k1 = int((hk.t.view(torch.int32) != k1.t.view(torch.int32)).sum())
        tri_vs_k1 = int(((hk.tri != k1.tri) | (hk.inst != k1.inst)).sum())
        untied_vs_k1 = traversal.unexplained_differences(col, o, d, hk, k1)
        phase("paged_vs_plain", kernel=k, rays=n_rays, t_bitwise_diff=n_t, max_ulp=max_ulp,
              tri_diff=n_tri, inst_diff=n_inst, plain_ms=f"{plain_ms:.2f}", t_bitwise_diff_vs_k1=t_vs_k1,
              tri_or_inst_diff_vs_k1=tri_vs_k1, unexplained_vs_k1=untied_vs_k1,
              hit_fraction=f"{float((hk.tri >= 0).float().mean()):.4f}")
        check(n_t == 0 and n_tri == 0 and n_inst == 0, f"{k} differs from its plain version")
        check(untied_vs_k1 == 0, f"{k} differs from K1 on the unpaged scene for another "
              "reason than the order of box tests (traversal.unexplained_differences)")
        check(t_vs_k1 <= ORDER_DIFFS_MAX * n_rays, f"{k}'s t differs from K1's on {t_vs_k1} rays")
        pg = sc.paged
        # the tables the kernel reads: the pages' node records, and K4's and
        # K5's top tree
        tables = (pg.node, pg.node_base, pg.page_tri0)
        if k != "K6":
            tables += (pg.top_code, pg.top_box)
        res[k] = {"hit": hp, "max_abs": max_abs, "plain_ms": plain_ms,
                  "bound": bound(k, counters, arity, n_rays, (o, d, *tables, *hk[:3]),
                                 col_rows)}
    _, k1_counters = traversal.cast_rays_wide_torch(col, o, d, stats=True)
    res["K1"] = {"bound": bound("K1 on the colonnade", k1_counters, 4, n_rays,
                                (o, d, col.wide4.wnode, *k1[:3]), col_rows)}
    wo, wd = paged_major._tile_rays(o, d)[1:]
    plan_res = plan_vs_plain(wide_sc, wo, wd, "colonnade_1920x1088")

    # 14. 192 sampled rays against the brute cast -----------------------
    o512, d512, sample = sample_192(dev, cam.pose)
    brute = cast_rays_brute(col, o512, sample, tri_chunk=1 << 16)
    for k, (sc, cast, _, _) in cases.items():
        h = cast(sc, o512, sample)
        far = brute_unexplained(col, o512, sample, h, brute)
        phase("brute_sample", kernel=k, rays=192, t_not_close=far[0], unexplained=far[1],
              tri_diffs=int((h.tri != brute.tri).sum()), hits=int((brute.tri >= 0).sum()))
        check(far[1] == 0, f"{k} t differs from the brute cast on the 192-ray sample")

    # 15. K6 on the two-instance colonnade ------------------------------
    t0 = time.perf_counter()
    pair, pcam = scene_colonnade_pair(512, 512, device=dev)
    pair = pair.with_paging()
    pair_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    for view, pose in (("recipe", pcam.pose), ("aerial", PAIR_AERIAL_POSE)):
        pp = Camera.looking(512, 512, fov_deg=65.0, pose=pose).ray_params(dev)
        po, pd = generate_rays(512, 512, pp["K_inv"], pp["D"], pp["pose"], pp["inv_pose"])
        hk6 = paged_major.cast_rays_paged_major_cuda(pair, po, pd)
        hp6 = paged_major.cast_rays_paged_major_torch(pair, po, pd)
        hl = traversal.cast_rays_cuda(pair, po, pd)  # K1: every instance in turn
        torch.cuda.synchronize()
        n_t, _, pair_abs, n_tri, n_inst = compare_hits(hk6, hp6)
        t_vs_k1 = int((hk6.t.view(torch.int32) != hl.t.view(torch.int32)).sum())
        untied_vs_k1 = traversal.unexplained_differences(pair, po, pd, hk6, hl)
        _, _, mask = paged_major.page_major_plan(pair, *paged_major._tile_rays(po, pd)[1:])
        plan_vs_plain(pair, *paged_major._tile_rays(po, pd)[1:], f"pair_{view}")
        ys = torch.from_numpy(rng.integers(0, 512, 96)).to(dev)
        xs = torch.from_numpy(rng.integers(0, 512, 96)).to(dev)
        sample = pd[ys, xs]
        hs = paged_major.cast_rays_paged_major_cuda(pair, po, sample)
        bs = cast_rays_brute(pair, po, sample, tri_chunk=1 << 16)
        far = brute_unexplained(pair, po, sample, hs, bs)
        hits = {i: int((hk6.inst == i).sum()) for i in range(pair.num_instances)}
        phase("k6_pair", view=view, triangles=pair.num_triangles,
              instances=pair.num_instances, build_s=f"{pair_s:.2f}",
              items_streamed=mask.shape[0], item_grid=pair.num_instances * pair.paged.num_pages,
              t_bitwise_diff=n_t, tri_diff=n_tri, inst_diff=n_inst,
              t_bitwise_diff_vs_k1=t_vs_k1, unexplained_vs_k1=untied_vs_k1,
              hits_per_instance=hits, sample_t_not_close=far[0], sample_unexplained=far[1],
              sample_inst_diffs=int((hs.inst != bs.inst).sum()))
        check(n_t == 0 and n_tri == 0 and n_inst == 0,
              f"K6 differs from its plain version (pair, {view} camera)")
        check(untied_vs_k1 == 0 and t_vs_k1 <= ORDER_DIFFS_MAX * pd.numel() // 3,
              "K6 differs from K1 on the two-instance colonnade beyond the order of box tests")
        check(far[1] == 0, f"K6 t differs from the brute cast on the pair's {view} sample")
        res["K6"]["max_abs"] = max(res["K6"]["max_abs"], pair_abs)
    check(min(hits.values()) > 0, "the aerial camera did not hit both instances")

    # 16. the paged main paths ------------------------------------------
    def counts():
        return {**{k: build.LAUNCHES[k] for k in ("K1", "K3", "K4", "K5", "K6")},
                "plan": build.LAUNCHES["K6_plan"]}

    img_k1 = render_image(RenderConfig(1920, 1088, backend="cuda"), col, *args)
    frames = {}
    for k, backend in (("K4", "paged"), ("K5", "paged"), ("K6", "paged_major")):
        sc = cases[k][0]
        config = RenderConfig(1920, 1088, backend=backend)
        build.reset_launches()
        img = render_image(config, sc, *args)
        torch.cuda.synchronize()
        n = counts()
        img_plain = shade_primary(sc, hit_attributes(sc, o, d, res[k]["hit"]))
        n_img = int((img != img_plain).any(-1).sum())
        phase("paged_main_path", kernel=k, backend=backend, launches=n,
              pixels_vs_plain=n_img, pixels_vs_cuda_backend=int((img != img_k1).any(-1).sum()))
        with_plan = 2 if k == "K6" else 1
        check(n[k] == 1 and sum(n.values()) == with_plan and n["plan"] == with_plan - 1,
              f"the {backend} frame did not launch {k} once (and K6's plan once)")
        check(n_img == 0, f"{n_img} pixels of the {backend} frame differ from the plain casts'")
        res[k]["launches"] = n[k]
        if k == "K6":
            plan_res["launches"] = n["plan"]
        frames[k] = lambda config=config, sc=sc: render_image(config, sc, *args)

    # 17. times ---------------------------------------------------------
    casts = {"K1": (col, traversal.cast_rays_cuda)}
    casts.update({k: (sc, cast) for k, (sc, cast, _, _) in cases.items()})
    kernel_names = {"K1": "wide_traverse_kernel", "K4": "paged_wide_kernel",
                    "K5": "paged_binary_kernel", "K6": "paged_major_kernel"}
    out = {}
    for size, (ro, rd) in (("512", (o512, d512)), ("1920x1088", (o, d))):
        for k, (sc, cast) in casts.items():
            fn = lambda sc=sc, cast=cast: cast(sc, ro, rd)
            fn()
            out[f"{k}_{size}_ms"] = min(event_ms(fn, 10) for _ in range(5))
            out[f"{k}_{size}_kernel_ms"] = device_ms(fn, kernel_names[k])
    plan = lambda: paged_major.page_major_plan(wide_sc, wo, wd)
    plan()
    out["K6_plan_1920x1088_ms"] = min(event_ms(plan, 10) for _ in range(3))
    card_plan = lambda: paged_major.page_major_plan_cuda(wide_sc, wo, wd)
    card_plan()
    out["K6_card_plan_1920x1088_ms"] = min(event_ms(card_plan, 10) for _ in range(3))
    out["K6_card_plan_1920x1088_kernel_ms"] = device_ms(card_plan, "page_plan_")
    plan_res["ms"] = out["K6_card_plan_1920x1088_kernel_ms"]
    plan_res["plain_ms"] = out["K6_plan_1920x1088_ms"]
    frames["K1"] = lambda: render_image(RenderConfig(1920, 1088), col, *args)
    for k, fn in frames.items():
        fn()
        best, median = best_and_median_ms(fn, loops=3, n=5)
        out[f"frame_{k}_best_ms"], out[f"frame_{k}_median_ms"] = best, median
    phase("paged_time", card=repr(card), **{k: f"{v:.4f}" for k, v in out.items()})

    names = {
        "K4": ("K4 paged_traverse, 4-wide pages (launches: the colonnade frame through "
               "the paged backend; ms: the kernel, 1920x1088 rays)", "tpu_raytracer/kernels/paged_wide.py:242"),
        "K5": ("K5 paged_binary_kernel, binary pages on walk.cuh (launches: the colonnade "
               "frame through the paged backend on binary tables; ms: the kernel, 1920x1088 "
               "rays)",
               "tpu_raytracer/kernels/paged.py:106"),
        "K6": ("K6 paged_major, 4-wide pages on walk.cuh (launches: the colonnade frame "
               "through the paged_major backend; ms: the kernel without its plan, 1920x1088 "
               "rays)",
               "tpu_raytracer/kernels/paged_major.py:130"),
    }
    ctx = {"col": col, "args": args, "o": o, "d": d, "k1": k1, "res": res, "casts": casts,
           "kernel_names": kernel_names}
    src = {"K4": "paged_traverse.cu", "K5": "paged_traverse.cu", "K6": "paged_major.cu"}
    plan_entry = {
        "name": "K6 page_plan (K6's visibility plan: item order and per-tile item lists; "
                "launches: the colonnade frame through the paged_major backend, 4 kernels "
                "each; ms: the 4 kernels, 1920x1088 rays; plain_ms: the plain plan, eager "
                "PyTorch with a host sync; replaces the plain jnp plan beside the TPU kernel, "
                "not a pallas_call)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/page_plan.cu",
        "replaces": "tpu_raytracer/kernels/paged_major.py:387",
        "launches": plan_res["launches"],
        "max_abs_err": plan_res["max_abs"],
        "ms": plan_res["ms"],
        "plain_ms": plan_res["plain_ms"],
        **plan_res["bound"],
    }
    return [{
        "name": names[k][0],
        "route": "cuda",
        "source": f"tpu_raytracer_torch/kernels/csrc/{src[k]}",
        "replaces": names[k][1],
        "launches": res[k]["launches"],
        "max_abs_err": res[k]["max_abs"],
        "ms": out[f"{k}_1920x1088_kernel_ms"],
        "plain_ms": res[k]["plain_ms"],
        **res[k]["bound"],
    } for k in ("K4", "K5", "K6")] + [plan_entry], ctx


def path_phases(dev, card, flagship, flagship_shadow) -> tuple:
    """Phases 18-23: kernel K2 and the path-traced main path of config 5
    through the ``bvh`` (K2) and ``cuda`` (K1) backends; returns K2's
    entries of the kernels line (nearest and any hit), and config 5's
    scene, poses and bounce rays for ``optimize_phase``. ``flagship`` is
    (scene, origin, dirs) of phase 3, ``flagship_shadow`` its shadow rays
    (origins, directions)."""
    from tpu_raytracer_torch.app.controls import fly_through
    from tpu_raytracer_torch.app.scenes import scene_colonnade
    from tpu_raytracer_torch.kernels import binary, build, traversal
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, integrators, render_image_ao,
        render_image_path_traced, render_radiance_path_traced,
    )
    from tpu_raytracer_torch.render.denoise import atrous_denoise
    from tpu_raytracer_torch.render.shade import SHADOW_EPS
    from tpu_raytracer_torch.render.sorted_cast import (
        cast_rays_sorted, park_dead_rays, ray_sort_keys,
    )
    from tpu_raytracer_torch.core.vecmath import FLT_MAX
    from tpu_raytracer_torch.utils import prng

    # 18. config 5: the colonnade at its defaults and its fly-through ---
    t0 = time.perf_counter()
    col, cam = scene_colonnade(PATH_SIZE, PATH_SIZE, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    poses = list(fly_through(cam.pose, frames=FLY_FRAMES, forward_per_frame=0.15))

    def params(pose, w=PATH_SIZE, h=PATH_SIZE):
        p = Camera.looking(w, h, fov_deg=65.0, pose=pose).ray_params(dev)
        return p["K_inv"], p["D"], p["pose"], p["inv_pose"]

    phase("config5", triangles=col.num_triangles, real_triangles=real_tri_rows(col),
          binary_nodes=col.binary.code.shape[0], binary_depth=col.binary.depth,
          wide_nodes=col.wide4.wcode.shape[0], host_build_s=f"{build_s:.2f}", poses=len(poses),
          samples=PATH_SAMPLES, bounces=PATH_BOUNCES)

    # 19. K2 against its plain version and K1 ---------------------------
    # the first bounce rays of frame 0, as render_path_traced makes them:
    # cosine samples off the primary hits with the frame key's first
    # subkey, one per sample, dead rays parked
    a0 = params(poses[0])
    o5, d5 = generate_rays(PATH_SIZE, PATH_SIZE, *a0)
    at = hit_attributes(col, o5, d5, binary.cast_rays_binary_cuda(col, o5, d5))
    # (bounce 0's draw: split(PRNGKey(0), PATH_BOUNCES + 1)[0])
    nd = integrators.sample_cosine(prng.PRNGKey(0, device=dev), (0,),
                                   at.normal[None].expand((PATH_SAMPLES,) + at.normal.shape))
    bo, bd = park_dead_rays(at.location[None] + nd * SHADOW_EPS, nd,
                            at.hit[None].expand(nd.shape[:-1]))
    sets = {"flagship_primary": flagship, "config5_bounce1": (col, bo, bd)}
    res = {}
    for tag, (sc, ro, rd) in sets.items():
        hk = binary.cast_rays_binary_cuda(sc, ro, rd)
        torch.cuda.synchronize()
        hp, counters = binary.cast_rays_binary_torch(sc, ro, rd, stats=True)
        n_t, max_ulp, max_abs, n_tri, n_inst = compare_hits(hk, hp)
        k1 = traversal.cast_rays_cuda(sc, ro, rd)
        occ = binary.cast_rays_binary_cuda(sc, ro, rd, occlusion=True)
        torch.cuda.synchronize()
        t_vs_k1 = int((hk.t.view(torch.int32) != k1.t.view(torch.int32)).sum())
        unexplained = traversal.unexplained_differences(sc, ro, rd, hk, k1)
        occ_diff = int(((occ.t < 0) != (hk.t < FLT_MAX)).sum() + ((occ.t >= FLT_MAX)
                                                                  != (hk.t >= FLT_MAX)).sum())
        n_rays = rd.numel() // 3
        phase("k2_vs_plain", rays=tag, n=n_rays, shape=tuple(rd.shape[:-1]),
              t_bitwise_diff=n_t, max_ulp=max_ulp, max_abs_err=max_abs, tri_diff=n_tri,
              inst_diff=n_inst, t_bitwise_diff_vs_k1=t_vs_k1,
              tri_or_inst_diff_vs_k1=int(((hk.tri != k1.tri) | (hk.inst != k1.inst)).sum()),
              unexplained_vs_k1=unexplained, any_hit_answer_diff=occ_diff,
              hit_fraction=f"{float((hk.tri >= 0).float().mean()):.4f}")
        check(n_t == 0 and n_tri == 0 and n_inst == 0, f"K2 differs from its plain version on {tag}")
        check(unexplained == 0, f"K2 differs from K1 on {tag} for another reason than the "
              "order of box tests (traversal.unexplained_differences)")
        check(occ_diff == 0, f"K2's any-hit answers differ from its nearest hits on {tag}")
        cast = lambda sc=sc, ro=ro, rd=rd: binary.cast_rays_binary_cuda(sc, ro, rd)
        cast()
        cast_ms = min(event_ms(cast, 10) for _ in range(3))
        kernel_ms = device_ms(cast, "binary_traverse_kernel")
        k1_ms = device_ms(lambda sc=sc, ro=ro, rd=rd: traversal.cast_rays_cuda(sc, ro, rd),
                          "wide_traverse_kernel")
        plain_ms = event_ms(lambda sc=sc, ro=ro, rd=rd: binary.cast_rays_binary_torch(sc, ro, rd),
                            1)
        phase("time_k2", card=repr(card), rays=tag, k2_kernel_ms=f"{kernel_ms:.4f}",
              k2_cast_ms=f"{cast_ms:.4f}", k1_kernel_ms_same_rays=f"{k1_ms:.4f}",
              k2_plain_ms=f"{plain_ms:.2f}")
        tree = sc.binary
        res[tag] = {"max_abs": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
                    "t_vs_k1": t_vs_k1,
                    "bound": bound(f"K2 {tag}", counters, 2, n_rays,
                                   (ro, rd, tree.node, *hk[:3]), real_tri_rows(sc))}

    # K2's any-hit mode on the flagship's shadow rays: its answers against
    # its nearest hits and the plain any-hit cast, its kernel time, bound
    # from the plain nearest walk's counts (more than the any-hit walk does)
    fsc = flagship[0]
    occ = binary.cast_rays_binary_cuda(fsc, *flagship_shadow, occlusion=True)
    near = binary.cast_rays_binary_cuda(fsc, *flagship_shadow)
    plain_occ, occ_counters = binary.cast_rays_binary_torch(fsc, *flagship_shadow,
                                                            occlusion=True, stats=True)
    torch.cuda.synchronize()
    occ_diff = int(((occ.t < 0) != (near.t < FLT_MAX)).sum() + (occ.t != plain_occ.t).sum())
    any_cast = lambda: binary.cast_rays_binary_cuda(fsc, *flagship_shadow, occlusion=True)
    any_cast()
    any_ms = device_ms(any_cast, "binary_traverse_kernel")
    k1_any_ms = device_ms(lambda: traversal.cast_rays_cuda(fsc, *flagship_shadow, occlusion=True),
                          "wide_traverse_kernel")
    any_plain_ms = event_ms(lambda: binary.cast_rays_binary_torch(fsc, *flagship_shadow,
                                                                  occlusion=True), 1)
    n_shadow = flagship_shadow[1].numel() // 3
    any_bound = bound("K2 any-hit flagship_shadow", occ_counters, 2, n_shadow,
                      (*flagship_shadow, fsc.binary.node, *occ[:3]), real_tri_rows(fsc))
    phase("time_k2", card=repr(card), rays="flagship_shadow", any_hit=True, n=n_shadow,
          occluded_fraction=f"{float((plain_occ.t < 0).float().mean()):.4f}",
          answer_diff_vs_nearest_and_plain=occ_diff, k2_kernel_ms=f"{any_ms:.4f}",
          k1_kernel_ms_same_rays=f"{k1_any_ms:.4f}", bound_ms=f"{any_bound['bound_ms']:.4f}",
          share_of_bound=f"{any_bound['bound_ms'] / any_ms:.4f}",
          k2_plain_ms=f"{any_plain_ms:.2f}")
    check(occ_diff == 0, "K2's any-hit answers differ from its nearest hits on the flagship's "
          "shadow rays")

    # K1's bound on the bounce rays (its time: [sort] pixel order)
    _, k1_counters = traversal.cast_rays_wide_torch(col, bo, bd, stats=True)
    bound("K1 config5_bounce1", k1_counters, 4, bd.numel() // 3,
          (bo, bd, col.wide4.wnode, *traversal.cast_rays_cuda(col, bo, bd)[:3]), real_tri_rows(col))

    # the coherence sort that sort_secondary turns on for the cuda
    # backend's bounce casts: K1's kernel on the bounce rays in pixel order
    # (the default) and in sort order, and the whole casts, the sorted one
    # with its argsort, gathers and scatter
    order = torch.argsort(ray_sort_keys(bo.reshape(-1, 3), bd.reshape(-1, 3)), stable=True)
    so, sd = bo.reshape(-1, 3)[order].contiguous(), bd.reshape(-1, 3)[order].contiguous()
    unsorted_cast = lambda: traversal.cast_rays_cuda(col, bo, bd)
    presorted_cast = lambda: traversal.cast_rays_cuda(col, so, sd)
    sorted_cast = lambda: cast_rays_sorted(traversal.cast_rays_cuda, col, bo, bd)
    phase("sort", card=repr(card), rays="config5_bounce1",
          k1_kernel_ms_pixel_order=f"{device_ms(unsorted_cast, 'wide_traverse_kernel'):.4f}",
          k1_kernel_ms_sort_order=f"{device_ms(presorted_cast, 'wide_traverse_kernel'):.4f}",
          unsorted_cast_ms=f"{min(event_ms(unsorted_cast, 10) for _ in range(3)):.4f}",
          sorted_cast_ms=f"{min(event_ms(sorted_cast, 10) for _ in range(3)):.4f}")

    # 20. the path main path: the fly-through through bvh and cuda ------
    def counts():
        return {k: build.LAUNCHES[k] for k in ("K1", "K2", "K3")}

    def frame(backend, k, **kw):
        config = RenderConfig(PATH_SIZE, PATH_SIZE, backend=backend, **kw.pop("config", {}))
        return render_image_path_traced(config, col, *params(poses[k]), prng.PRNGKey(k),
                                        PATH_BOUNCES, PATH_SAMPLES, **kw)

    images, launches = {}, {}
    for backend, kname in (("bvh", "K2"), ("cuda", "K1")):
        per_frame, imgs = [], []
        for k in range(FLY_FRAMES):
            build.reset_launches()
            imgs.append(frame(backend, k))
            torch.cuda.synchronize()
            n = counts()
            per_frame.append(n[kname])
            launches.setdefault(kname, n[kname])
            check(n[kname] == 3 and sum(n.values()) == 3,
                  f"frame {k} through {backend} launched {n}, not {kname} 3 times")
        with plain_casts():
            n_plain = int((imgs[0] != frame(backend, 0)).any(-1).sum())
        build.reset_launches()
        lit = frame(backend, 0, config={"path_lights": True})
        torch.cuda.synchronize()
        lit_launches = counts()[kname]
        fields = {}
        if backend == "cuda":  # the bounce and tail casts are unsorted by default
            fields["sorted_vs_unsorted_pixels"] = int(
                (imgs[0] != frame("cuda", 0, sort_secondary=True)).any(-1).sum())
            check(fields["sorted_vs_unsorted_pixels"] == 0, "the sort changed the path image")
        phase("path", backend=backend, kernel=kname, shape=tuple(imgs[0].shape),
              launches_per_frame=per_frame, launches_with_path_lights=lit_launches,
              pixels_vs_plain=n_plain, bounce_casts_sorted=False, **fields,
              image_mean=f"{float(torch.stack(imgs).float().mean()):.3f}")
        check(n_plain == 0, f"{n_plain} pixels of the {backend} path frame differ from the "
              "plain casts' frame")
        check(lit_launches == 6, f"the NEE frame launched {kname} {lit_launches} times, not 6")
        images[backend] = imgs
    bvh_vs_cuda = [int((a != b).any(-1).sum()) for a, b in zip(images["bvh"], images["cuda"])]
    phase("path_bvh_vs_cuda", pixels_per_frame=bvh_vs_cuda,
          frame0_bounce1_rays_t_diff=res["config5_bounce1"]["t_vs_k1"],
          note="K2 and K1 differ only by box order (k2_vs_plain unexplained_vs_k1=0)")

    # 21. config 5 against its CPU golden -------------------------------
    g_scene, g_cam = scene_colonnade(64, 64, columns=4, segs=8, device=dev)
    g_p = g_cam.ray_params(dev)
    mism = {b: _golden_mismatch(render_image_path_traced(
        RenderConfig(64, 64, backend=b), g_scene, g_p["K_inv"], g_p["D"], g_p["pose"],
        g_p["inv_pose"], prng.PRNGKey(7), 2, 2), "config5_colonnade_path_64")
        for b in ("bvh", "cuda")}
    phase("golden5", **{f"{b}_mismatch": v for b, v in mism.items()},
          bound=GOLDEN5_MAX_MISMATCH)
    check(max(mism.values()) <= GOLDEN5_MAX_MISMATCH, f"config 5 golden mismatch {mism}")

    # 22. AO and denoise against their plain-cast frames ----------------
    ao_cfg = RenderConfig(PATH_SIZE, PATH_SIZE, backend="bvh")
    build.reset_launches()
    ao = render_image_ao(ao_cfg, col, *a0, prng.PRNGKey(0), AO_SAMPLES, 1.0)
    torch.cuda.synchronize()
    ao_launches = counts()["K2"]
    with plain_casts():
        ao_plain = int((ao != render_image_ao(ao_cfg, col, *a0, prng.PRNGKey(0), AO_SAMPLES,
                                              1.0)).any(-1).sum())
    phase("ao", backend="bvh", samples=AO_SAMPLES, launches=ao_launches,
          pixels_vs_plain=ao_plain, mean=f"{float(ao.float().mean()):.3f}")
    check(ao_launches == AO_SAMPLES + 1 and ao_plain == 0, "the AO frame is off")
    build.reset_launches()
    den = frame("bvh", 0, config={"denoise": 3})
    torch.cuda.synchronize()
    den_launches = counts()["K2"]
    with plain_casts():
        den_plain = int((den != frame("bvh", 0, config={"denoise": 3})).any(-1).sum())
    phase("denoise", backend="bvh", iterations=3, launches=den_launches,
          pixels_vs_plain=den_plain, pixels_vs_noisy=int((den != images["bvh"][0]).any(-1).sum()))
    check(den_launches == 4 and den_plain == 0, "the denoised frame is off")

    # 23. times of the path frame and of its denoiser --------------------
    for size, w, h, bounces, samples in PATH_TIMES:
        pa = params(poses[0], w, h)
        out = {}
        for backend in ("bvh", "cuda"):
            cfg = RenderConfig(w, h, backend=backend)
            fn = lambda cfg=cfg: render_image_path_traced(cfg, col, *pa, prng.PRNGKey(0),
                                                          bounces, samples)
            fn()
            best, median = best_and_median_ms(fn, loops=3, n=2 if w > 512 else 5)
            out[f"{backend}_best_ms"], out[f"{backend}_median_ms"] = f"{best:.4f}", f"{median:.4f}"
        rad = render_radiance_path_traced(RenderConfig(w, h, backend="cuda"), col, *pa,
                                          prng.PRNGKey(0), bounces, samples)
        o_p, d_p = generate_rays(w, h, *pa)
        g = hit_attributes(col, o_p, d_p, traversal.cast_rays_cuda(col, o_p, d_p))
        guides = (torch.where(g.hit[..., None], g.normal, 0.0),
                  torch.where(g.hit, g.t, torch.full_like(g.t, float("inf"))))
        den_ms = min(event_ms(lambda: atrous_denoise(rad, *guides, iterations=3), 3)
                     for _ in range(3))
        phase("path_time", card=repr(card), size=size, samples=samples, bounces=bounces,
              rays_per_bounce=samples * w * h, **out,
              denoise_3_iterations_ms=f"{den_ms:.4f}")

    flag = res["flagship_primary"]
    ctx = {"col": col, "poses": poses, "bounce": (bo, bd), "res": res}
    return [{
        "name": "K2 binary_traverse (binary BVH, walk.cuh at arity 2; launches: a config 5 "
                "path frame through the bvh backend, primary + bounce + any-hit tail; ms, "
                "plain_ms, bound: the frame's first bounce rays [2, 512, 512]; on the "
                f"flagship's primary rays {flag['ms']:.4f} ms, bound "
                f"{flag['bound']['bound_ms']:.4f} ms)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
        "replaces": "tpu_raytracer/kernels/traversal.py:308",
        "launches": launches["K2"],
        "max_abs_err": max(r["max_abs"] for r in res.values()),
        "ms": res["config5_bounce1"]["ms"],
        "plain_ms": res["config5_bounce1"]["plain_ms"],
        **res["config5_bounce1"]["bound"],
    }, {
        "name": "K2 binary_traverse any-hit mode (the flagship's shadow rays; launches: a "
                "config 5 path frame through the bvh backend, of which the any-hit tail is "
                "one; bound from the nearest-hit walk's counts, more than the any-hit walk "
                "does)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/wide_traverse.cu",
        "replaces": "tpu_raytracer/kernels/traversal.py:308",
        "launches": launches["K2"],
        "max_abs_err": float((occ.t.double() - plain_occ.t.double()).abs().max()),
        "ms": any_ms,
        "plain_ms": any_plain_ms,
        **any_bound,
    }], ctx


def _field_diffs(hk, hp) -> dict:
    """Per field of two hit records (the carried ones too), the entries
    whose bits differ; fails where one record carries a field the other
    does not."""
    diff = {}
    for field, a, b in zip(hk._fields, hk, hp):
        check((a is None) == (b is None), f"one cast carried {field} and the other did not")
        if a is not None:
            diff[field] = int((_bits(a) != _bits(b)).sum()) if a.is_floating_point() \
                else int((a != b).sum())
    return diff


def cross_tree_unexplained(split, unsplit, origin, dirs, a, b):
    """(rays whose t differs between hits ``a`` on one tree and ``b`` on
    another tree of the same mesh, those of them not explained): each
    cast's t must equal the brute cast's of its own scene within
    BRUTE_RTOL or differ from it by the order of box tests
    (``brute_unexplained``)."""
    from tpu_raytracer_torch.render import Hit
    from tpu_raytracer_torch.render.renderer import cast_rays_brute

    diff = torch.nonzero((a.t.view(torch.int32) != b.t.view(torch.int32)).reshape(-1)).squeeze(1)
    if diff.numel() == 0:
        return 0, 0
    dd = dirs.reshape(-1, 3)[diff]
    oo = origin.expand(dirs.shape).reshape(-1, 3)[diff]
    out = 0
    for sc, h in ((split, a), (unsplit, b)):
        sub = Hit(*(x.reshape(-1)[diff] for x in h[:3]))
        out += brute_unexplained(sc, oo, dd, sub, cast_rays_brute(sc, oo, dd, tri_chunk=1 << 16))[1]
    return int(diff.numel()), out


def flatten_phases(dev, card, config4, instances16) -> None:
    """Phases 24-25: config 4 and the 16-instance scene with their static
    instances baked into one world-space mesh (``flatten=True``,
    bench_all's configs 4b and 6b): K1 (carrying u, v and n) against its
    plain version in every field, the frames' launches (K1 only) and
    pixels against their plain casts' and the instanced scenes' frames,
    and K1's device time on the baked scene beside K3's on the instanced
    one, in turns, each with its bound. ``config4`` is (scene, origin,
    dirs, camera args, Whitted frame, K3's per-set times) of phases 6-11,
    ``instances16`` (scene, camera, origin, dirs) of phase 6."""
    from tpu_raytracer_torch.app.scenes import scene_instances, scene_instances16
    from tpu_raytracer_torch.kernels import build, tlas, traversal
    from tpu_raytracer_torch.render import (
        RenderConfig, hit_attributes, render_image, render_image_whitted,
    )
    from tpu_raytracer_torch.render.integrators import _reflect
    from tpu_raytracer_torch.render.shade import SHADOW_EPS
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
    from tpu_raytracer_torch.core.vecmath import normalize

    inst4, o4, d4, args4, img_w, k3_per_set = config4
    inst16, cam16, o16, d16 = instances16
    p16 = cam16.ray_params(dev)
    args16 = (p16["K_inv"], p16["D"], p16["pose"], p16["inv_pose"])
    W, H = SLICE_SIZE

    def k1_vs_plain(tag, sc, ro, rd):
        uv, n = traversal.carry_fields(sc, rd, False, True, True)
        hk = traversal.cast_rays_cuda(sc, ro, rd, want_normals=True, carry=True)
        hp, stats = traversal.cast_rays_wide_torch(sc, ro, rd, stats=True, carry_uv=uv, carry_n=n)
        torch.cuda.synchronize()
        diff = _field_diffs(hk, hp)
        phase("flatten_vs_plain", rays=tag, n=rd.numel() // 3, carry_uv=uv, carry_n=n,
              **{f"{f}_bitwise_diff": v for f, v in diff.items()},
              hit_fraction=f"{float((hk.tri >= 0).float().mean()):.4f}")
        check(not any(diff.values()), f"K1 differs from its plain version on {tag}: {diff}")
        return hk, stats

    def frame_checks(sc, fn, instanced_img):
        build.reset_launches()
        img = fn(sc)
        torch.cuda.synchronize()
        n = {k: build.LAUNCHES[k] for k in ("K1", "K1_carry", "K3")}
        with plain_casts():
            n_plain = _pixels(img, fn(sc))
        share = float((img == instanced_img).all(-1).float().mean())
        return img, n, n_plain, share

    def k1_k3_times(sc_flat, sc_inst, ro, rd, stats_flat, k3_bound):
        """Device ms of K1 on the baked scene and K3 on the instanced one,
        in turns (K1, K3, K3, K1), without and with the carry."""
        out = {}
        for carry in (False, True):
            suffix = "_carry" if carry else ""
            k1 = lambda: traversal.cast_rays_cuda(sc_flat, ro, rd, want_normals=carry, carry=carry)
            k3 = lambda: tlas.cast_rays_tlas_cuda(sc_inst, ro, rd, want_normals=carry, carry=carry)
            ms = {"k1": [], "k3": []}
            for which in ("k1", "k3", "k3", "k1"):
                if which == "k1":
                    ms[which].append(device_ms(k1, f"wide_traverse{suffix}_kernel"))
                else:
                    ms[which].append(device_ms(k3, f"tlas_traverse{suffix}_kernel"))
            out[f"k1_flat{suffix}_ms"] = f"{min(ms['k1']):.4f}"
            out[f"k3_instanced{suffix}_ms"] = f"{min(ms['k3']):.4f}"
        h = traversal.cast_rays_cuda(sc_flat, ro, rd, carry=False)
        b = bound("K1 flattened", stats_flat, 4, rd.numel() // 3,
                  (ro, rd, sc_flat.wide4.wnode, *h[:3]), real_tri_rows(sc_flat))
        out["k1_flat_bound_ms"] = f"{b['bound_ms']:.4f}"
        out["k3_instanced_bound_ms"] = f"{k3_bound:.4f}"
        return out

    # 24. config 4 flattened ----------------------------------------------
    t0 = time.perf_counter()
    flat4, _ = scene_instances(W, H, device=dev, flatten=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    h4, stats4 = k1_vs_plain("config4_flat_primary", flat4, o4, d4)
    a4 = hit_attributes(flat4, o4, d4, h4)
    rd4 = normalize(_reflect(d4, a4.normal))
    k1_vs_plain("config4_flat_reflection", flat4,
                *park_dead_rays(a4.location + rd4 * SHADOW_EPS, rd4, a4.hit))
    whitted = lambda sc: render_image_whitted(RenderConfig(W, H, backend="cuda"), sc, *args4)
    img, n, n_plain, share = frame_checks(flat4, whitted, img_w)
    fl_best, fl_med = best_and_median_ms(lambda: whitted(flat4), loops=3, n=3)
    in_best, in_med = best_and_median_ms(lambda: whitted(inst4), loops=3, n=3)
    phase("flatten", scene="config4", triangles=flat4.num_triangles,
          real_triangles=real_tri_rows(flat4), instances=flat4.num_instances,
          max_tri_mat=int(flat4.tri_mat.max()), build_s=f"{build_s:.2f}",
          k1_launches=n["K1"], k1_carry_launches=n["K1_carry"], k3_launches=n["K3"],
          pixels_vs_plain=n_plain, identical_share_vs_instanced=f"{share:.4f}",
          whitted_frame_ms_best_flat=f"{fl_best:.4f}", whitted_frame_ms_median_flat=f"{fl_med:.4f}",
          whitted_frame_ms_best_instanced=f"{in_best:.4f}",
          whitted_frame_ms_median_instanced=f"{in_med:.4f}", card=repr(card),
          **k1_k3_times(flat4, inst4, o4, d4, stats4, k3_per_set["primary"]["bound_ms"]))
    check(flat4.num_instances == 1 and int(flat4.tri_mat.max()) == 3,
          "config 4 flattened is not one instance with per-triangle materials")
    check(n["K1"] == 6 and n["K1_carry"] == 3 and n["K3"] == 0,
          f"the flattened Whitted frame launched {n}, not K1 6 times (3 carrying) and K3 never")
    check(n_plain == 0, f"{n_plain} pixels of the flattened Whitted frame differ from its plain "
          "casts' frame")
    check(share >= 0.97, f"the flattened Whitted frame equals the instanced one on only {share:.4f}")

    # 25. the 16 instances flattened ---------------------------------------
    flat16, _ = scene_instances16(W, H, device=dev, flatten=True)
    h16, stats16 = k1_vs_plain("instances16_flat_primary", flat16, o16, d16)
    primary = lambda sc: render_image(RenderConfig(W, H, backend="cuda"), sc, *args16)
    img16 = primary(inst16)
    _, n, n_plain, share = frame_checks(flat16, primary, img16)
    _, k3_stats = tlas.cast_rays_tlas_torch(inst16, o16, d16, stats=True)
    h3 = tlas.cast_rays_tlas_cuda(inst16, o16, d16, carry=False)
    k3_bound = bound("K3 instances16", k3_stats, 4, d16.numel() // 3,
                     (o16, d16, inst16.wide4.wnode, inst16.tlas.code, inst16.tlas.box, *h3[:3]),
                     real_tri_rows(inst16))["bound_ms"]
    phase("flatten16", scene="instances16", triangles=flat16.num_triangles,
          instances=flat16.num_instances, max_tri_mat=int(flat16.tri_mat.max()),
          k1_launches=n["K1"], k3_launches=n["K3"], pixels_vs_plain=n_plain,
          identical_share_vs_instanced=f"{share:.4f}", card=repr(card),
          **k1_k3_times(flat16, inst16, o16, d16, stats16, k3_bound))
    check(flat16.num_instances == 1, "the 16 instances flattened are not one instance")
    check(n["K1"] == 1 and n["K3"] == 0, f"the flattened 16-instance frame launched {n}")
    check(n_plain == 0, f"{n_plain} pixels of the flattened 16-instance frame differ from its "
          "plain casts' frame")
    check(share >= 0.97, f"the flattened 16-instance frame equals the instanced one on only "
          f"{share:.4f}")


def presplit_phase(dev, card, ctx) -> None:
    """Phase 26: the colonnade of phases 12-17 built with ``presplit=1.3``
    (duplicated triangle references, clipped boxes): K1, K4, K5 and K6
    (with its card plan) bitwise against their plain versions on the
    1920x1088 rays and against K1 on the same tree and on the unsplit
    tree (every difference explained by box order), the three paged
    frames against their plain casts' frames, and each kernel's device
    time on the unsplit and the split tree in turns, with bounds. ``ctx``
    is ``paged_phases``'."""
    from tpu_raytracer_torch.kernels import build, paged, paged_major, traversal
    from tpu_raytracer_torch.render import RenderConfig, hit_attributes, render_image, shade_primary
    from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

    col, args, o, d, k1_unsplit = ctx["col"], ctx["args"], ctx["o"], ctx["d"], ctx["k1"]
    n_rays = d.numel() // 3
    v = procgen.colonnade(18, 18, 40)
    t0 = time.perf_counter()
    mesh = MeshPrimitive.from_triangles(*v, presplit=1.3, cache_dir=False)
    build_s = time.perf_counter() - t0
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    scene.add_mesh(mesh)
    scene.add_mesh_instance(MeshInstance(0, 0))
    t0 = time.perf_counter()
    split = scene.compile(dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide_sc, bin_sc = split.with_paging(), split.with_paging(wide=False)
    paging_s = time.perf_counter() - t0
    rows = real_tri_rows(split)
    phase("presplit", triangles=len(v[0]), refs=len(mesh.bvh.order), leaf_rows=rows,
          rows_8_aligned=split.num_triangles, unsplit_rows_8_aligned=col.num_triangles,
          build_s=f"{build_s:.2f}", compile_s=f"{compile_s:.2f}", paging_s=f"{paging_s:.2f}",
          pages=wide_sc.paged.num_pages, unsplit_wide_nodes=col.wide4.wcode.shape[0],
          wide_nodes=split.wide4.wcode.shape[0], wide_depth=split.wide4.depth,
          binary_depth=split.binary.depth, page_depth_wide=wide_sc.paged.depth,
          top_depth=wide_sc.paged.top_depth)
    check(rows == len(mesh.bvh.order) > len(v[0]), "presplit made no duplicated references")

    cases = {
        "K1": (split, traversal.cast_rays_cuda, traversal.cast_rays_wide_torch, 4,
               (split.wide4.wnode,)),
        "K4": (wide_sc, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch, 4, None),
        "K5": (bin_sc, paged.cast_rays_paged_cuda, paged.cast_rays_paged_torch, 2, None),
        "K6": (wide_sc, paged_major.cast_rays_paged_major_cuda,
               paged_major.cast_rays_paged_major_torch, 4, None),
    }
    k1_split = traversal.cast_rays_cuda(split, o, d)
    hits, bounds = {}, {}
    for k, (sc, cast, plain, arity, tables) in cases.items():
        hk = cast(sc, o, d)
        torch.cuda.synchronize()
        (hp, counters), plain_ms = timed(lambda: plain(sc, o, d, stats=True))
        n_t, max_ulp, _, n_tri, n_inst = compare_hits(hk, hp)
        same_tree = traversal.unexplained_differences(split, o, d, hk, k1_split)
        n_cross, cross = cross_tree_unexplained(split, col, o, d, hk, k1_unsplit)
        phase("presplit_vs_plain", kernel=k, rays=n_rays, t_bitwise_diff=n_t, max_ulp=max_ulp,
              tri_diff=n_tri, inst_diff=n_inst, plain_ms=f"{plain_ms:.2f}",
              unexplained_vs_k1=same_tree, t_bitwise_diff_vs_unsplit_k1=n_cross,
              unexplained_vs_unsplit_k1=cross,
              hit_fraction=f"{float((hk.tri >= 0).float().mean()):.4f}")
        check(n_t == 0 and n_tri == 0 and n_inst == 0, f"{k} differs from its plain version on "
              "the presplit colonnade")
        check(same_tree == 0 and cross == 0, f"{k} on the presplit colonnade differs from K1 for "
              "another reason than the order of box tests")
        check(n_cross <= ORDER_DIFFS_MAX * n_rays, f"{k}'s t on the presplit tree differs from "
              f"K1's on the unsplit tree on {n_cross} rays")
        if tables is None:
            pg = sc.paged
            tables = (pg.node, pg.node_base, pg.page_tri0)
            tables += (pg.top_code, pg.top_box) if k != "K6" else ()
        hits[k] = hp
        bounds[k] = bound(f"{k} presplit", counters, arity, n_rays, (o, d, *tables, *hk[:3]), rows)
    wo, wd = paged_major._tile_rays(o, d)[1:]
    plan_vs_plain(wide_sc, wo, wd, "presplit_colonnade_1920x1088")

    frames = {}
    for k, backend in (("K4", "paged"), ("K5", "paged"), ("K6", "paged_major")):
        sc = cases[k][0]
        build.reset_launches()
        img = render_image(RenderConfig(d.shape[1], d.shape[0], backend=backend), sc, *args)
        torch.cuda.synchronize()
        n = {**{k: build.LAUNCHES[k] for k in ("K1", "K3", "K4", "K5", "K6")},
             "plan": build.LAUNCHES["K6_plan"]}
        n_img = _pixels(img, shade_primary(sc, hit_attributes(sc, o, d, hits[k])))
        frames[k] = n_img
        phase("presplit_main_path", kernel=k, backend=backend, launches=n, pixels_vs_plain=n_img)
        with_plan = 2 if k == "K6" else 1
        check(n[k] == 1 and sum(n.values()) == with_plan and n["plan"] == with_plan - 1,
              f"the presplit {backend} frame did not launch {k} once (and K6's plan once)")
        check(n_img == 0, f"{n_img} pixels of the presplit {backend} frame differ from the plain "
              "casts'")

    out = {}
    for k in cases:
        u_sc, cast = ctx["casts"][k]
        s_sc = cases[k][0]
        ms = {"unsplit": [], "split": []}
        for which in ("unsplit", "split", "split", "unsplit"):
            sc = u_sc if which == "unsplit" else s_sc
            ms[which].append(device_ms(lambda sc=sc, cast=cast: cast(sc, o, d),
                                       ctx["kernel_names"][k]))
        out[f"{k}_unsplit_ms"] = f"{min(ms['unsplit']):.4f}"
        out[f"{k}_split_ms"] = f"{min(ms['split']):.4f}"
        out[f"{k}_unsplit_bound_ms"] = f"{ctx['res'][k]['bound']['bound_ms']:.4f}"
        out[f"{k}_split_bound_ms"] = f"{bounds[k]['bound_ms']:.4f}"
    plan = lambda: paged_major.page_major_plan_cuda(wide_sc, wo, wd)
    out["K6_card_plan_split_ms"] = f"{device_ms(plan, 'page_plan_'):.4f}"
    phase("presplit_time", card=repr(card), rays="colonnade_1920x1088", **out)


def optimize_phase(dev, card, ctx) -> None:
    """Phase 27: config 5's colonnade with two rounds of the reinsertion
    optimizer (``opt_rounds=2``, bench_all's config 5b): SAH before and
    after, K1 and K2 bitwise against their plain versions on frame 0's
    first bounce rays and against the plain tree's casts (differences
    explained by box order), the path frame through ``bvh`` and ``cuda``
    against its plain casts' frame, and K1's and K2's device time on the
    optimized and the plain tree in turns. ``ctx`` is ``path_phases``'."""
    from tpu_raytracer_torch.accel.bvh import sah_cost
    from tpu_raytracer_torch.kernels import binary, build, traversal
    from tpu_raytracer_torch.render import Camera, RenderConfig, render_image_path_traced
    from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen
    from tpu_raytracer_torch.utils import prng

    col5, poses, (bo, bd) = ctx["col"], ctx["poses"], ctx["bounce"]
    v = procgen.colonnade(10, 10, 32)
    t0 = time.perf_counter()
    plain_mesh = MeshPrimitive.from_triangles(*v, cache_dir=False)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = MeshPrimitive.from_triangles(*v, opt_rounds=2, cache_dir=False)
    opt_s = time.perf_counter() - t0
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    scene.add_mesh(mesh)
    scene.add_mesh_instance(MeshInstance(0, 0))
    opt = scene.compile(dev)
    sah_plain, sah_opt = sah_cost(plain_mesh.bvh), sah_cost(mesh.bvh)
    phase("optimize", triangles=len(v[0]), rounds=2, sah_plain=f"{sah_plain:.4f}",
          sah_optimized=f"{sah_opt:.4f}", build_s=f"{plain_s:.2f}",
          build_and_optimize_s=f"{opt_s:.2f}", bvh_depth_plain=plain_mesh.bvh.stats()["max_depth"],
          bvh_depth_optimized=mesh.bvh.stats()["max_depth"], binary_depth=opt.binary.depth,
          binary_depth_plain=col5.binary.depth, wide_depth=opt.wide4.depth,
          wide_depth_plain=col5.wide4.depth)
    check(sah_opt < sah_plain, f"the optimizer did not lower the SAH ({sah_opt} >= {sah_plain})")

    n_rays = bd.numel() // 3
    kernels = {"K1": (traversal.cast_rays_cuda, traversal.cast_rays_wide_torch, 4,
                      lambda sc: (sc.wide4.wnode,), "wide_traverse_kernel"),
               "K2": (binary.cast_rays_binary_cuda, binary.cast_rays_binary_torch, 2,
                      lambda sc: (sc.binary.node,), "binary_traverse_kernel")}
    out = {}
    for k, (cast, plain, arity, tables, kname) in kernels.items():
        hk = cast(opt, bo, bd)
        torch.cuda.synchronize()
        hp, counters = plain(opt, bo, bd, stats=True)
        n_t, max_ulp, _, n_tri, n_inst = compare_hits(hk, hp)
        n_cross, cross = cross_tree_unexplained(opt, col5, bo, bd, hk, cast(col5, bo, bd))
        phase("optimize_vs_plain", kernel=k, rays="config5_bounce1", n=n_rays,
              t_bitwise_diff=n_t, max_ulp=max_ulp, tri_diff=n_tri, inst_diff=n_inst,
              t_bitwise_diff_vs_plain_tree=n_cross, unexplained_vs_plain_tree=cross)
        check(n_t == 0 and n_tri == 0 and n_inst == 0, f"{k} differs from its plain version on "
              "the optimized tree")
        check(cross == 0, f"{k} on the optimized tree differs from the plain tree for another "
              "reason than the order of box tests")
        b = bound(f"{k} optimized config5_bounce1", counters, arity, n_rays,
                  (bo, bd, *tables(opt), *hk[:3]), real_tri_rows(opt))
        ms = {"plain_tree": [], "optimized": []}
        for which in ("plain_tree", "optimized", "optimized", "plain_tree"):
            sc = col5 if which == "plain_tree" else opt
            ms[which].append(device_ms(lambda sc=sc, cast=cast: cast(sc, bo, bd), kname))
        out[f"{k}_plain_tree_ms"] = f"{min(ms['plain_tree']):.4f}"
        out[f"{k}_optimized_ms"] = f"{min(ms['optimized']):.4f}"
        out[f"{k}_plain_tree_bound_ms"] = f"{ctx['res']['config5_bounce1']['bound']['bound_ms']:.4f}" \
            if k == "K2" else "see [bound] K1 config5_bounce1"
        out[f"{k}_optimized_bound_ms"] = f"{b['bound_ms']:.4f}"

    p = Camera.looking(PATH_SIZE, PATH_SIZE, fov_deg=65.0, pose=poses[0]).ray_params(dev)
    pargs = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    for backend, kname in (("bvh", "K2"), ("cuda", "K1")):
        cfg = RenderConfig(PATH_SIZE, PATH_SIZE, backend=backend)
        fn = lambda sc, cfg=cfg: render_image_path_traced(cfg, sc, *pargs, prng.PRNGKey(0),
                                                          PATH_BOUNCES, PATH_SAMPLES)
        build.reset_launches()
        img = fn(opt)
        torch.cuda.synchronize()
        n = {k: build.LAUNCHES[k] for k in ("K1", "K2", "K3")}
        with plain_casts():
            n_plain = _pixels(img, fn(opt))
        times = {}
        for which in ("plain_tree", "optimized", "optimized", "plain_tree"):
            sc = col5 if which == "plain_tree" else opt
            best = best_and_median_ms(lambda sc=sc: fn(sc), loops=3, n=3)[0]
            times[which] = min(times.get(which, best), best)
        phase("optimize_path", backend=backend, kernel=kname, launches=n, pixels_vs_plain=n_plain,
              pixels_vs_plain_tree=_pixels(img, fn(col5)),
              frame_ms_best_optimized=f"{times['optimized']:.4f}",
              frame_ms_best_plain_tree=f"{times['plain_tree']:.4f}", card=repr(card))
        check(n[kname] == 3 and sum(n.values()) == 3, f"the optimized path frame through {backend} "
              f"launched {n}, not {kname} 3 times")
        check(n_plain == 0, f"{n_plain} pixels of the optimized path frame ({backend}) differ from "
              "its plain casts' frame")
    phase("optimize_time", card=repr(card), rays="config5_bounce1", **out)


def scene_io_phases(dev, ctx) -> None:
    """Phases 28-29: config 5's colonnade saved and loaded again
    (``SceneTensors.save``/``load``), the flagship's mesh written as an
    OBJ file and loaded through the native parser, ``compile_cached``
    cold and warm, the BVH disk cache cold and warm on the colonnade of
    the paged phases, each in a fresh temporary directory; then the
    cube's checkerboard written as a PNG, read back by
    ``Material.upload_texture`` and rendered at 1920x1088 against the
    in-memory texture's frame. ``ctx`` is ``path_phases``'."""
    import shutil

    from tpu_raytracer_torch.render import Camera, render
    from tpu_raytracer_torch.scene import (
        Material, MeshInstance, MeshPrimitive, Scene, SceneTensors, cache, objloader, procgen,
    )
    from tpu_raytracer_torch.utils.image import save_png

    def diff_fields(a: dict, b: dict) -> list:
        return [k for k in a if k not in b or a[k].shape != b[k].shape
                or a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()]

    bvh_fields = ("node_min", "node_max", "child_a", "child_b", "leaf_start", "leaf_count", "order")

    def mesh_diffs(a, b) -> list:
        out = [f for f in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2")
               if getattr(a, f).tobytes() != getattr(b, f).tobytes()]
        return out + [f for f in bvh_fields if getattr(a.bvh, f).tobytes()
                      != getattr(b.bvh, f).tobytes()]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_scene_io_")
    try:
        # 28. save/load, OBJ file, compile cache, BVH cache -------------------
        col5 = ctx["col"]
        fp = os.path.join(tmp, "colonnade.npz")
        t0 = time.perf_counter()
        col5.save(fp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = SceneTensors.load(fp, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = col5.numpy_fields(), back.numpy_fields()
        differ = diff_fields(a, b) + diff_fields(b, a)
        tables_equal = (torch.equal(_bits(col5.wide4.wnode), _bits(back.wide4.wnode))
                        and torch.equal(_bits(col5.binary.node), _bits(back.binary.node)))
        phase("scene_io", what="save_load", scene="config5_colonnade",
              triangles=col5.num_triangles, fields=len(a), differing_fields=len(differ),
              tables_equal=tables_equal, file_mb=f"{os.path.getsize(fp) / 1e6:.2f}",
              save_s=f"{save_s:.2f}", load_s=f"{load_s:.2f}")
        check(not differ and tables_equal, f"the saved and loaded colonnade differs in {differ}")

        v = procgen.blob(subdivisions=6)
        lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in np.stack(v, 1).reshape(-1, 3).tolist()]
        lines += [f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}" for k in range(len(v[0]))]
        obj = os.path.join(tmp, "flagship.obj")
        with open(obj, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(obj) as f:
            text = f.read()
        objloader.parse_obj("v 0 0 0\n", native=True)  # build the parser before timing it
        t0 = time.perf_counter()
        objloader.parse_obj(text)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        objloader.parse_obj(text, native=False)
        parse_numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = objloader.load(obj)
        load_obj_s = time.perf_counter() - t0
        differ = mesh_diffs(loaded, MeshPrimitive.from_triangles(*v))
        phase("scene_io", what="obj_file", triangles=loaded.num_triangles,
              file_mb=f"{os.path.getsize(obj) / 1e6:.2f}",
              native=len(text) > objloader.NATIVE_OBJ_THRESHOLD,
              parse_native_s=f"{parse_s:.4f}", parse_numpy_s=f"{parse_numpy_s:.4f}",
              load_with_bvh_s=f"{load_obj_s:.2f}", differing_fields_vs_in_memory=len(differ))
        check(len(text) > objloader.NATIVE_OBJ_THRESHOLD, "the OBJ text is below the native "
              "parser's threshold")
        check(not differ, f"the OBJ file's mesh differs from the in-memory mesh in {differ}")

        scene = Scene()
        scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
        scene.add_mesh(MeshPrimitive.from_triangles(*procgen.colonnade(10, 10, 32),
                                                    cache_dir=False))
        scene.add_mesh_instance(MeshInstance(0, 0))
        cdir = os.path.join(tmp, "scenes")
        t0 = time.perf_counter()
        cold = cache.compile_cached(scene, cdir, device=dev)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = cache.compile_cached(scene, cdir, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene.compile(dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        differ = diff_fields(cold.numpy_fields(), warm.numpy_fields())
        differ += diff_fields(cold.numpy_fields(), col5.numpy_fields())
        phase("scene_io", what="compile_cached", scene="config5_colonnade",
              entries=len(os.listdir(cdir)), cold_s=f"{cold_s:.2f}", warm_s=f"{warm_s:.2f}",
              compile_without_cache_s=f"{compile_s:.2f}", differing_fields=len(differ))
        check(not differ and len(os.listdir(cdir)) == 1, f"compile_cached differs in {differ}")

        v = procgen.colonnade(18, 18, 40)
        bdir = os.path.join(tmp, "bvh")
        t0 = time.perf_counter()
        m_cold = MeshPrimitive.from_triangles(*v, cache_dir=bdir)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_warm = MeshPrimitive.from_triangles(*v, cache_dir=bdir)
        warm_s = time.perf_counter() - t0
        differ = mesh_diffs(m_cold, m_warm)
        entries = os.listdir(bdir)
        phase("scene_io", what="bvh_cache", triangles=len(v[0]), entries=len(entries),
              entry_mb=f"{os.path.getsize(os.path.join(bdir, entries[0])) / 1e6:.2f}",
              cold_s=f"{cold_s:.2f}", warm_s=f"{warm_s:.2f}", differing_fields=len(differ))
        check(not differ and len(entries) == 1, f"the BVH cache's tree differs in {differ}")

        # 29. a texture from a PNG file --------------------------------------
        tex = procgen.checkerboard_texture(128, 8)
        png = os.path.join(tmp, "checker.png")
        save_png(tex, png)
        frames, textures = [], []
        for from_file in (False, True):
            cube = Scene()
            mat = Material()
            if from_file:
                t0 = time.perf_counter()
                mat.upload_texture(png)
                read_s = time.perf_counter() - t0
            else:
                mat.set_texture(tex)
            textures.append(mat.texture)
            cube.add_material(mat)
            cube.add_mesh(objloader.loads(procgen.cube_obj()))
            cube.add_mesh_instance(MeshInstance(0, 0))
            cam = Camera.looking(1920, 1088, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
            frames.append(render(cam, cube.compile(dev), backend="cuda"))
        texels = int((textures[0] != textures[1]).any(-1).sum())
        n_img = _pixels(frames[0], frames[1])
        phase("texture_file", png_bytes=os.path.getsize(png), read_s=f"{read_s:.4f}",
              texels_vs_in_memory=texels, pixels_vs_in_memory=n_img,
              textured_pixels=int((frames[1] != frames[1][0, 0]).any(-1).sum()))
        check(texels == 0 and n_img == 0, f"the PNG texture's frame differs from the in-memory "
              f"texture's ({texels} texels, {n_img} pixels)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The multi-device phases: frames timed per configuration and case, after
# one untimed frame
SHARD_REPS = 5


# the benchmark's AO cell (rtbench/configs/colonnade.json,
# rtbench/traffic/ao_1080p.json): the lap's centre, eye height, step and
# yaw a frame, AO's radius, and the poses and rows of [ao_bound]
AO_LAP = ((11.0, 11.0), 1.6, 0.05, 0.01)
AO_RADIUS = 1.0
AO_POSES = (0, 150, 300, 450)
AO_ROW_STEP = 12
WARP = 32


def _lap_pose(k: int) -> list:
    """Pose k of the AO cell's lap (``rtbench/pose.py lap``): vertex k of
    the polygon that ``fly_through`` steps, looking along yaw k * step."""
    (cx, cy), height, forward, yaw_step = AO_LAP
    yaw = yaw_step * k
    apothem = (forward / 2.0) / np.tan(yaw_step / 2.0)
    return [cx - apothem * np.cos(yaw) - forward / 2.0 * np.sin(yaw),
            cy + apothem * np.sin(yaw) - forward / 2.0 * np.cos(yaw), height, yaw, 0.0, 0.0]


def _walk_counts(stats: dict, live: torch.Tensor) -> dict:
    """Pops and tests per live ray (mean, 99th percentile) and the mean
    over warps of 32 consecutive rays of their largest count."""
    out = {}
    for k in ("pops", "tests"):
        c = stats[k].double()
        out[f"{k}_mean"] = float(c[live].mean())
        out[f"{k}_p99"] = float(torch.quantile(c[live], 0.99))
        out[f"{k}_warp_max_mean"] = float(c.reshape(-1, WARP).amax(1).mean())
    return out


def ao_bound_phase(dev, card) -> None:
    """``[ao_bound]``: K1 on AO's first sample draw of the benchmark's AO
    cell, unbounded and bounded by its radius (phase 41 of the module
    docstring)."""
    from tpu_raytracer_torch.app.scenes import scene_colonnade
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.render import Camera, generate_rays, hit_attributes
    from tpu_raytracer_torch.render.integrators import sample_cosine
    from tpu_raytracer_torch.render.shade import SHADOW_EPS
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays
    from tpu_raytracer_torch.utils import prng

    scene, _ = scene_colonnade(1920, 1080, device=dev)
    key = prng.PRNGKey(2147500301, device=dev)
    for k in AO_POSES:
        p = Camera.looking(1920, 1080, fov_deg=65.0, pose=_lap_pose(k)).ray_params(dev)
        o, d = generate_rays(1920, 1080, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        attrs = hit_attributes(scene, o, d, traversal.cast_rays_cuda(scene, o, d,
                                                                    want_normals=True))
        nd = sample_cosine(key, (0,), attrs.normal)
        ro, rd = park_dead_rays(attrs.location + nd * SHADOW_EPS, nd, attrs.hit)
        casts = {"unbounded": lambda: traversal.cast_rays_cuda(scene, ro, rd),
                 "bounded": lambda: traversal.cast_rays_cuda(scene, ro, rd, t_max=AO_RADIUS)}
        ms = {name: [] for name in casts}
        for name in ("unbounded", "bounded", "bounded", "unbounded"):
            ms[name].append(device_ms(casts[name], "wide_traverse_kernel"))
        rows = (slice(None, None, AO_ROW_STEP),)
        so, sd = ro[rows].reshape(-1, 3), rd[rows].reshape(-1, 3)
        live = attrs.hit[rows].reshape(-1)
        counts, hits = {}, {}
        for name, bound in (("unbounded", traversal.BIG), ("bounded", AO_RADIUS)):
            hk = casts[name]()
            hp, stats = traversal.cast_rays_wide_torch(scene, so, sd, stats=True, t_max=bound)
            sel = lambda x: x[rows].reshape(-1)
            check(torch.equal(_bits(sel(hk.t)), _bits(hp.t)) and torch.equal(sel(hk.tri), hp.tri)
                  and torch.equal(sel(hk.inst), hp.inst),
                  f"[ao_bound] K1 {name} differs from its plain walk at pose {k}")
            counts[name], hits[name] = _walk_counts(stats, live), hp
        occluded = {name: h.t < AO_RADIUS for name, h in hits.items()}
        both = occluded["unbounded"] & occluded["bounded"]
        flips = int((occluded["unbounded"] != occluded["bounded"]).sum())
        t_diff = int((hits["unbounded"].t[both] != hits["bounded"].t[both]).sum())
        phase("ao_bound", card=repr(card), pose=k, rays=rd.numel() // 3,
              unbounded_ms=json.dumps([round(x, 6) for x in ms["unbounded"]]),
              bounded_ms=json.dumps([round(x, 6) for x in ms["bounded"]]),
              bounded_over_unbounded=f"{sum(ms['bounded']) / sum(ms['unbounded']):.4f}",
              sample_rays=so.shape[0], live=int(live.sum()), occluded_flips=flips,
              t_diff_occluded=t_diff,
              unbounded=json.dumps({k2: round(v, 3) for k2, v in counts["unbounded"].items()}),
              bounded=json.dumps({k2: round(v, 3) for k2, v in counts["bounded"].items()}))


def _launch_counts() -> dict:
    """Each kernel's launches (its carrying kernel's included, not apart)."""
    from tpu_raytracer_torch.render.compiled import launch_counts

    return {k: v for k, v in launch_counts().items() if not k.endswith("_carry")}


def _reset_launch_counts() -> None:
    from tpu_raytracer_torch.kernels import build

    build.reset_launches()


def _frames(fn) -> dict:
    """One frame of ``fn`` with the kernel launches it made (counts set to
    0 just before, read just after), then ``SHARD_REPS`` timed frames
    (host clock around each, ended by a synchronize)."""
    _reset_launch_counts()
    img = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _launch_counts().items() if v}
    times = []
    for _ in range(SHARD_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"img": img, "launches": launches, "best_ms": times[0],
            "median_ms": times[len(times) // 2]}


def _graph_shard_case(group, eager, fast, cfg, scene, args, extra) -> dict:
    """This rank's part of a ``[graph_shard]`` case: the compiled entry
    point ``fast`` against the eager ``eager`` at ``GRAPH_POSES`` poses
    (launch counts set to 0 just before, read just after; pixels apart, a
    checksum of each compiled frame, the eager frame's launches against
    those of a replay, the collectives of ``scene_shard._all_reduce`` made
    inside the capture), then both ``GRAPH_TURNS`` times in turns."""
    import hashlib

    from tpu_raytracer_torch.parallel import scene_shard
    from tpu_raytracer_torch.render.compiled import launch_counts

    saved, collectives = scene_shard._all_reduce, {"captured": 0, "eager": 0}

    def counted(g, x, op):
        collectives["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return saved(g, x, op)

    n0 = len(fast.entries)
    _reset_launch_counts()
    diffs, sums, eager_launches, captured = [], [], [], None
    for step in range(GRAPH_POSES):
        a = _posed(args, step)
        scene_shard._all_reduce = counted if step == 0 else saved
        try:
            got = fast(cfg, group, scene, *a, *extra)
        finally:
            scene_shard._all_reduce = saved
        torch.cuda.synchronize()
        if captured is None:  # the warm-up frame and the capture
            captured = {k: v for k, v in launch_counts().items() if v}
        before = launch_counts()
        want = eager(cfg, group, scene, *a, *extra)
        torch.cuda.synchronize()
        after = launch_counts()
        eager_launches.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        diffs.append(_pixels(got, want))
        sums.append(hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest())
        if step == 0:
            # the same frame through the plain stages: no S1-S6 launch
            s0 = _stage_counts()
            with plain_stages():
                plain = eager(cfg, group, scene, *a, *extra)
            torch.cuda.synchronize()
            vs_plain = _pixels(got, plain)
            plain_launches = {k: v - s0[k] for k, v in _stage_counts().items() if v != s0[k]}
    entry = fast.last
    call = (cfg, group, scene, *args, *extra)
    times = _in_turns({"eager": lambda: eager(*call), "replay": lambda: fast(*call)},
                      GRAPH_TURNS)
    return {"entry": fast.name, "pixels_vs_eager": diffs, "pixels_vs_plain_stages": vs_plain,
            "plain_stage_launches": plain_launches, "sums": sums,
            "launches_per_replay": entry.launches, "eager_launches": eager_launches,
            "counts_at_capture": captured, "entries_added": len(fast.entries) - n0,
            "replays": entry.replays, "capture_s": entry.capture_s,
            "collectives_in_capture": collectives["captured"],
            "collectives_in_warm_up": collectives["eager"], "times": times}


def shard_rank(group, rows: dict, scene_part: tuple) -> dict:
    """A ``parallel.spawn`` worker: this rank's part of ``[shard_rows]``,
    ``[shard_scene]`` and ``[graph_shard]``. ``rows``: {case: (entry,
    config, scene, camera args, extra args)}, each frame rendered with
    ``_frames``, then through its compiled entry point
    (``_graph_shard_case``). ``scene_part``: (this rank's chunk, camera
    args, configs, graph cases): the scene-sharded cast of the camera's
    rays (with this rank's own K1 cast of its chunk beside it) and a frame
    per config, with the CUDA-event milliseconds of the frame's
    collectives (``scene_shard._all_reduce``); then each graph case
    {case: (entry name, config, camera args, extra args)} through its
    compiled entry point, which under gloo must refuse the group."""
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.parallel import scene_shard, sharding
    from tpu_raytracer_torch.parallel.group import to_device
    from tpu_raytracer_torch.render import generate_rays, pipeline

    out = {}
    for name, (entry, cfg, scene, args, extra) in rows.items():
        scene, args, extra = to_device((scene, args, extra), group.device)
        out[name] = _frames(lambda: entry(cfg, group, scene, *args, *extra))
        out[name]["graph"] = _graph_shard_case(
            group, entry, getattr(sharding, "compiled_" + entry.__name__), cfg, scene, args,
            extra)
        pipeline.clear_compiled()
        del scene
        torch.cuda.empty_cache()
    shard, args, configs, graph_cases = to_device(scene_part, group.device)
    o, d = generate_rays(configs[0].width, configs[0].height, *args)
    out["local"] = traversal.cast_rays_cuda(shard.scene, o, d)
    out["cast"] = scene_shard.cast_rays_scene_sharded(group, shard, o, d, backend="cuda")
    saved, marks = scene_shard._all_reduce, []

    def timed_all_reduce(g, x, op):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x = saved(g, x, op)
        end.record()
        marks.append((start, end))
        return x

    for cfg in configs:
        frames = _frames(lambda: scene_shard.render_image_scene_sharded(cfg, group, shard, *args))
        scene_shard._all_reduce = timed_all_reduce
        try:
            marks.clear()
            scene_shard.render_image_scene_sharded(cfg, group, shard, *args)
            torch.cuda.synchronize()
        finally:
            scene_shard._all_reduce = saved
        frames["combine_ms"] = sum(s.elapsed_time(e) for s, e in marks)
        frames["collectives"] = len(marks)
        out["scene_" + cfg.lighting] = frames
    for name, (entry, cfg, cargs, extra) in graph_cases.items():
        eager, fast = (getattr(scene_shard, n) for n in (entry, "compiled_" + entry))
        if group.backend != "nccl":
            try:
                fast(cfg, group, shard, *cargs, *extra)
                out[name] = {"refused": None}
            except ValueError as e:
                out[name] = {"refused": str(e)}
            continue
        out[name] = _graph_shard_case(group, eager, fast, cfg, shard, cargs, extra)
        pipeline.clear_compiled()
        torch.cuda.empty_cache()
    return out


def table_bytes(scene) -> int:
    """Bytes of every tensor of a compiled scene, its traversal tables
    included."""
    out = sum(getattr(scene, f).numel() * getattr(scene, f).element_size()
              for f in ("tri_v0", "tri_v1", "tri_v2", "tri_normal", "tri_uv0", "tri_uv1",
                        "tri_uv2", "tri_mesh", "tri_mat", "node_min", "node_max",
                        "node_child_a", "node_child_b", "node_leaf_start", "node_leaf_count"))
    for tables in (scene.wide4, scene.binary):
        out += sum(t.numel() * t.element_size() for t in vars(tables).values()
                   if isinstance(t, torch.Tensor))
    return out


def shard_unexplained(flat, shards, o, d, combined, local_hits, single) -> tuple:
    """(rays whose t differs between the scene-sharded cast ``combined``
    and the single-device cast ``single`` of the flattened scene ``flat``,
    rays among them that no visit order explains). Where the sharded hit
    is nearer, the flat scene's walk lost it: both hits are held to
    ``traversal.unexplained_differences`` in ``flat``. Where the flat
    scene's hit is nearer, the chunk holding its triangle lost it: that
    hit and the chunk's own hit (``local_hits``) are held to it in the
    chunk. Triangles are matched across scenes by their three vertices."""
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.render.renderer import Hit

    idx = torch.nonzero((combined.t.view(torch.int32) != single.t.view(torch.int32))
                        .reshape(-1)).squeeze(1)
    if idx.numel() == 0:
        return 0, 0
    rays_o = o.expand(d.shape).reshape(-1, 3)[idx]
    rays_d = d.reshape(-1, 3)[idx]
    pick = lambda h: Hit(*(x.reshape(-1)[idx] for x in h[:3]))
    comb, one = pick(combined), pick(single)
    verts = lambda sc, r: torch.cat([sc.tri_v0[r], sc.tri_v1[r], sc.tri_v2[r]])
    rows_of = lambda sc: torch.cat([sc.tri_v0, sc.tri_v1, sc.tri_v2], 1)

    def find(sc, v) -> int:
        hits = torch.nonzero((rows_of(sc) == v).all(1)).squeeze(1)
        return int(hits[0]) if hits.numel() else -1

    stride = shards[0].stride
    bad = 0
    near = comb.t < one.t  # every differing ray with comb.t >= one.t has one.t < comb.t
    if near.any():
        rows = [find(flat, verts(shards[g // stride].scene, g % stride))
                for g in comb.tri[near].tolist()]
        mapped = Hit(comb.t[near], torch.tensor(rows, dtype=torch.int32, device=o.device),
                     torch.zeros_like(comb.inst[near]))
        bad += traversal.unexplained_differences(flat, rays_o[near], rays_d[near], mapped,
                                                 Hit(*(x[near] for x in one[:3])))
    lost = torch.nonzero(~near).squeeze(1).tolist()
    for c, shard in enumerate(shards):
        sel, rows = [], []
        for i in lost:
            r = find(shard.scene, verts(flat, int(one.tri[i])))
            if r >= 0:
                sel.append(i)
                rows.append(r)
        if not sel:
            continue
        sel_t = torch.tensor(sel, device=o.device)
        mine = Hit(one.t[sel_t], torch.tensor(rows, dtype=torch.int32, device=o.device),
                   torch.zeros_like(one.inst[sel_t]))
        local = Hit(*(x.reshape(-1)[idx][sel_t] for x in local_hits[c][:3]))
        bad += traversal.unexplained_differences(shard.scene, rays_o[sel_t], rays_d[sel_t],
                                                 mine, local)
        lost = [i for i in lost if i not in sel]
    return idx.numel(), bad + len(lost)


def lex_min(local_hits, shards):
    """The nearest hit over the chunks, combined here from each rank's own
    cast of its chunk: the lexicographic (t, global tri) minimum, as
    ``parallel.scene_shard._combine_hit`` reduces it over the ranks."""
    from tpu_raytracer_torch.render.renderer import Hit

    keys = [(h.t.view(torch.int32).long() << 32)
            | torch.where(h.tri >= 0, h.tri.long() + s.shard * s.stride, 2 ** 30)
            for h, s in zip(local_hits, shards)]
    best = torch.stack(keys).min(dim=0).values
    gtri = best & 0xFFFFFFFF
    miss = gtri >= 2 ** 30
    return Hit((best >> 32).to(torch.int32).view(torch.float32),
               torch.where(miss, -1, gtri).to(torch.int32),
               torch.where(miss, -1, 0).to(torch.int32))


def shard_phases(dev, card, flagship, config4, paged_ctx, path_ctx) -> None:
    """Phases 30-32, the multi-device layer (``tpu_raytracer_torch/parallel``)
    with every rank on this card: one rank under NCCL, two under gloo
    (NCCL refuses two ranks on one card), and every card under NCCL where
    there are two or more.

    ``[shard_rows]``: row bands of the flagship (K1) and config 4's
    Whitted frame (K3) at 1920x1088, config 5's path frame at 512x512
    (K1; its bands sampled with the folded keys, against the same bands
    rendered here), and the 1M colonnade through ``paged`` (K4, K5) and
    ``paged_major`` (K6) at 1920x1088: every rank's frame bitwise equal to
    the unsharded frame, launches per rank, frame ms best and median.

    ``[shard_scene]``: the 1M colonnade flattened and split into one chunk
    per rank, cast with K1 at 1920x1088: the chunks' rows and table bytes
    against the whole scene's, K1's device time on a chunk against the
    whole scene, the t differences from the single-device cast of the
    flattened scene and how many no visit order explains (must be 0), the
    flat and ``lambert_shadow`` frames' pixels apart from the
    single-device frames, the combine's CUDA-event ms, the frame ms.

    ``[graph_shard]``: the same row-band cases at each world size, and the
    scene-shard primary (flat, ``lambert_shadow``), Whitted and path (at
    512x512) frames at one NCCL rank, through their compiled entry points
    (one CUDA graph per rank; the scene shards' graphs hold the combine's
    NCCL collectives): pixels apart from the eager sharded frame at
    ``GRAPH_POSES`` poses, a replay's launches against the eager frame's,
    the ranks' frames alike, the capture's seconds, the collectives made
    inside the capture, and eager against replayed frames ``GRAPH_TURNS``
    times in turns; under gloo the scene shards' compiled entry points
    must refuse the group.

    ``[shard_dryrun]``: ``python -m tpu_raytracer_torch.parallel.dryrun``
    (every compiled sharded entry point against its eager one) on one
    rank of this card under NCCL and on two under gloo, both at once."""
    import dataclasses
    import subprocess

    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.parallel import PerRank, shard_compile, spawn
    from tpu_raytracer_torch.parallel import sharding
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, render_image, render_image_whitted,
    )
    from tpu_raytracer_torch.render.integrators import render_path_traced, to_u8, tonemap
    from tpu_raytracer_torch.render.pipeline import path_options
    from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene, procgen
    from tpu_raytracer_torch.utils import prng

    from tpu_raytracer_torch.parallel.group import to_host as cpu

    fw, fh = SLICE_SIZE
    flag_scene, flag_args = flagship
    inst4, args4 = config4
    col = paged_ctx["col"]
    wide_sc, bin_sc = paged_ctx["casts"]["K4"][0], paged_ctx["casts"]["K5"][0]
    col_cpu = col.to("cpu")
    col5 = path_ctx["col"]
    p5 = Camera.looking(PATH_SIZE, PATH_SIZE, fov_deg=65.0,
                        pose=path_ctx["poses"][0]).ray_params(dev)
    args5 = (p5["K_inv"], p5["D"], p5["pose"], p5["inv_pose"])
    key = prng.PRNGKey(0)
    cfg = lambda w, h, backend, **kw: RenderConfig(w, h, backend=backend, **kw)
    # {case: (entry, config, scene on the card, camera args, extra args)}
    cases = {
        "flagship_K1": (sharding.render_image_sharded, cfg(fw, fh, "cuda"), flag_scene,
                        flag_args, ()),
        "config4_whitted_K3": (sharding.render_image_whitted_sharded, cfg(fw, fh, "cuda"), inst4,
                               args4, ()),
        "config5_path_512_K1": (sharding.render_image_path_traced_sharded,
                                cfg(PATH_SIZE, PATH_SIZE, "cuda"), col5, args5,
                                (key, PATH_BOUNCES, PATH_SAMPLES)),
        "colonnade_paged_K4": (sharding.render_image_sharded, cfg(fw, fh, "paged"), wide_sc,
                               paged_ctx["args"], ()),
        "colonnade_paged_K5": (sharding.render_image_sharded, cfg(fw, fh, "paged"), bin_sc,
                               paged_ctx["args"], ()),
        "colonnade_paged_major_K6": (sharding.render_image_sharded, cfg(fw, fh, "paged_major"),
                                     wide_sc, paged_ctx["args"], ()),
    }
    # the payload: scenes on the host, the colonnade's base tables shared
    # by its two page-table variants
    host_scene = {id(flag_scene): flag_scene.to("cpu"), id(inst4): inst4.to("cpu"),
                  id(col5): col5.to("cpu"),
                  id(wide_sc): dataclasses.replace(col_cpu, paged=wide_sc.paged.to("cpu")),
                  id(bin_sc): dataclasses.replace(col_cpu, paged=bin_sc.paged.to("cpu"))}
    rows = {name: (entry, c, host_scene[id(sc)], cpu(a), cpu(extra))
            for name, (entry, c, sc, a, extra) in cases.items()}

    # the unsharded frames and their times
    unsharded = {}
    for name, (entry, c, sc, a, extra) in cases.items():
        if entry is sharding.render_image_whitted_sharded:
            fn = lambda c=c, sc=sc, a=a: render_image_whitted(c, sc, *a)
        elif entry is sharding.render_image_sharded:
            fn = lambda c=c, sc=sc, a=a: render_image(c, sc, *a)
        else:
            fn = None
        unsharded[name] = _frames(fn) if fn is not None else None

    def path_bands(world: int) -> torch.Tensor:
        """Config 5's frame as ``world`` bands, band i sampled with
        ``fold_in(key, i)``, in this process."""
        c = cases["config5_path_512_K1"][1]
        o5, d5 = generate_rays(PATH_SIZE, PATH_SIZE, *args5)
        h = PATH_SIZE // world
        return torch.cat([to_u8(tonemap(render_path_traced(
            col5, o5, d5[i * h:(i + 1) * h].contiguous(), prng.fold_in(key.to(dev), i),
            max_bounces=PATH_BOUNCES, samples=PATH_SAMPLES, sort_secondary=False,
            **path_options(c)), c.tonemap, c.exposure)) for i in range(world)])

    # the scene to shard: the 1M colonnade as a host scene, flattened
    t0 = time.perf_counter()
    host = Scene()
    host.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    host.add_mesh(MeshPrimitive.from_triangles(*procgen.colonnade(18, 18, 40)))
    host.add_mesh_instance(MeshInstance(0, 0))
    flat = host.compile(dev, flatten_static=True)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    s_args = paged_ctx["args"]
    so, sd = generate_rays(fw, fh, *s_args)
    single = traversal.cast_rays_cuda(flat, so, sd)
    scene_cfgs = (cfg(fw, fh, "cuda"), cfg(fw, fh, "cuda", lighting="lambert_shadow"))
    # the colonnade's camera at the path frame's size
    p512 = Camera.looking(PATH_SIZE, PATH_SIZE, fov_deg=65.0,
                          pose=[1.0, -2.0, 1.6, 0, 0, 0]).ray_params("cpu")
    # [graph_shard]'s scene-shard cases: {case: (entry, config, camera args, extra)}
    graph_scene = {
        "shards_flat": ("render_image_scene_sharded", scene_cfgs[0], cpu(s_args), ()),
        "shards_lambert_shadow": ("render_image_scene_sharded", scene_cfgs[1], cpu(s_args), ()),
        "shards_whitted": ("render_image_whitted_scene_sharded", cfg(fw, fh, "cuda"),
                          cpu(s_args), ()),
        "shards_path_512": ("render_image_path_scene_sharded",
                           cfg(PATH_SIZE, PATH_SIZE, "cuda"),
                           tuple(p512[k] for k in ("K_inv", "D", "pose", "inv_pose")),
                           (key, PATH_BOUNCES, PATH_SAMPLES)),
    }
    single_frames = {c.lighting: _frames(lambda c=c: render_image(c, flat, *s_args))
                     for c in scene_cfgs}
    k1_whole_ms = device_ms(lambda: traversal.cast_rays_cuda(flat, so, sd),
                            "wide_traverse_kernel")

    ndev = torch.cuda.device_count()
    runs = [(1, "cuda:0", "nccl"), (2, "cuda:0", "gloo")]
    if ndev >= 2:
        runs.append((ndev, None, "nccl"))
    else:
        phase("shard_multi_card", run=False, reason=f"{ndev} CUDA card(s): NCCL across cards "
              "needs two or more")
    torch.cuda.empty_cache()
    for world, device, backend in runs:
        t0 = time.perf_counter()
        shards = shard_compile(host, world, device="cpu")
        shard_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn(shard_rank, world, device=device, backend=backend,
                      args=(rows, (PerRank(tuple(shards)), cpu(s_args), scene_cfgs,
                                   graph_scene)))
        spawn_s = time.perf_counter() - t0
        where = device or "cuda:{rank}"
        route = sharding.gather_route(backend, torch.device(device or "cuda:0"))

        # [shard_rows] ----------------------------------------------------
        for name in cases:
            res = [r[name] for r in ranks]
            img = res[0]["img"]
            same_ranks = all(torch.equal(r["img"], img) for r in res[1:])
            want = path_bands(world) if unsharded[name] is None else unsharded[name]["img"]
            n_px = int((img.to(dev) != want).any(-1).sum())
            ref = unsharded[name]
            phase("shard_rows", world=world, backend=backend, device=where, route=repr(route),
                  case=name, shape=tuple(img.shape), launches_rank0=res[0]["launches"],
                  pixels_vs_unsharded=n_px, ranks_agree=same_ranks,
                  frame_ms_best=f"{res[0]['best_ms']:.4f}",
                  frame_ms_median=f"{res[0]['median_ms']:.4f}",
                  unsharded_ms_best=f"{ref['best_ms']:.4f}" if ref else "n/a",
                  unsharded_ms_median=f"{ref['median_ms']:.4f}" if ref else "n/a",
                  card=repr(card))
            check(same_ranks, f"[shard_rows] {name}: the ranks hold different images")
            check(n_px == 0, f"[shard_rows] {name} at {world} ranks ({backend}): {n_px} pixels "
                  "differ from the unsharded frame")
            check(all(r["launches"] for r in res), f"[shard_rows] {name}: a rank launched "
                  "no kernel")

        # [shard_scene] ---------------------------------------------------
        casts = [r["cast"] for r in ranks]
        comb = casts[0]
        same_ranks = all(all(torch.equal(a, b) for a, b in zip(c[:3], comb[:3]))
                         for c in casts[1:])
        dev_shards = [s.to(dev) for s in shards]
        comb_d = type(comb)(*(x.to(dev) for x in comb[:3]))
        local_hits = [type(r["local"])(*(x.to(dev) for x in r["local"][:3])) for r in ranks]
        by_hand = lex_min(local_hits, dev_shards)
        combine_diff = sum(int((a.view(torch.int32) if a.is_floating_point() else a).ne(
            b.view(torch.int32) if b.is_floating_point() else b).sum())
            for a, b in zip(comb_d[:3], by_hand))
        n_t, unexplained = shard_unexplained(flat, dev_shards, so, sd, comb_d, local_hits, single)
        k1_chunk_ms = device_ms(lambda: traversal.cast_rays_cuda(dev_shards[0].scene, so, sd),
                                "wide_traverse_kernel")
        frames = {}
        for c in scene_cfgs:
            r0 = ranks[0]["scene_" + c.lighting]
            frames[c.lighting] = r0
            r0["pixels"] = int((r0["img"].to(dev) != single_frames[c.lighting]["img"])
                               .any(-1).sum())
            check(all(torch.equal(r["scene_" + c.lighting]["img"], r0["img"]) for r in ranks),
                  f"[shard_scene] the ranks hold different {c.lighting} frames")
        phase("shard_scene", world=world, backend=backend, device=where, scene="colonnade_1M",
              whole_rows=flat.num_triangles, whole_table_mb=f"{table_bytes(flat) / 1e6:.2f}",
              chunk_rows=[s.scene.num_triangles for s in shards],
              chunk_real_triangles=[real_tri_rows(s.scene) for s in shards],
              chunk_table_mb=[f"{table_bytes(s.scene) / 1e6:.2f}" for s in shards],
              stride=shards[0].stride, flatten_compile_s=f"{flat_s:.2f}",
              shard_compile_s=f"{shard_s:.2f}", spawn_and_run_s=f"{spawn_s:.2f}",
              k1_chunk0_kernel_ms=f"{k1_chunk_ms:.4f}", k1_whole_kernel_ms=f"{k1_whole_ms:.4f}",
              rays=sd.numel() // 3, combine_diff_vs_local_casts=combine_diff,
              t_diff_vs_single=n_t, unexplained=unexplained, ranks_agree=same_ranks,
              card=repr(card))
        for lighting, r0 in frames.items():
            ref = single_frames[lighting]
            phase("shard_scene_frame", world=world, backend=backend, lighting=lighting,
                  launches_rank0=r0["launches"], pixels_vs_single=r0["pixels"],
                  collectives=r0["collectives"], combine_ms=f"{r0['combine_ms']:.4f}",
                  frame_ms_best=f"{r0['best_ms']:.4f}", frame_ms_median=f"{r0['median_ms']:.4f}",
                  single_ms_best=f"{ref['best_ms']:.4f}",
                  single_ms_median=f"{ref['median_ms']:.4f}", card=repr(card))
            check(r0["pixels"] <= ORDER_DIFFS_MAX * fw * fh,
                  f"[shard_scene] {lighting}: {r0['pixels']} pixels from the single-device frame")
            check(r0["launches"].get("K1", 0) >= 1, f"[shard_scene] {lighting}: K1 not launched")
        check(same_ranks, "[shard_scene] the ranks' combined casts differ")
        check(combine_diff == 0, "[shard_scene] the combined cast is not the lexicographic "
              "minimum of the ranks' own casts")
        check(unexplained == 0, f"[shard_scene] {unexplained} of {n_t} t differences from the "
              "single-device cast are not explained by visit order")
        check(n_t <= ORDER_DIFFS_MAX * fw * fh, f"[shard_scene] t differs on {n_t} rays")

        # [graph_shard] ---------------------------------------------------
        for name in list(cases) + list(graph_scene):
            res = [r[name]["graph"] if name in cases else r[name] for r in ranks]
            if "refused" in res[0]:
                refused = [r["refused"] for r in res]
                phase("graph_shard", world=world, backend=backend, device=where, case=name,
                      entry="compiled_" + graph_scene[name][0], refused=repr(refused[0]))
                check(all(m is not None and "NCCL" in m for m in refused),
                      f"[graph_shard] {name}: the compiled entry point did not refuse a "
                      f"{backend} group on CUDA: {refused}")
                continue
            g = res[0]
            e, r = g["times"]["eager"], g["times"]["replay"]
            agree = all(x["sums"] == g["sums"] for x in res[1:])
            more = {}
            if name in graph_scene:
                more = {"collectives_in_capture": g["collectives_in_capture"],
                        "collectives_in_warm_up": g["collectives_in_warm_up"]}
            phase("graph_shard", world=world, backend=backend, device=where, case=name,
                  entry=g["entry"], pixels_vs_eager=[x["pixels_vs_eager"] for x in res],
                  launches_per_replay=g["launches_per_replay"],
                  pixels_vs_plain_stages=g["pixels_vs_plain_stages"],
                  eager_launches=g["eager_launches"][0], counts_at_capture=g["counts_at_capture"],
                  ranks_agree=agree, entries_added=g["entries_added"], replays=g["replays"],
                  capture_s=f"{g['capture_s']:.3f}", **more, turns=GRAPH_TURNS,
                  eager_ms_best=f"{e['best_ms']:.4f}", eager_ms_median=f"{e['median_ms']:.4f}",
                  eager_spread_10_90_ms=f"{e['spread_10_90_ms']:.4f}",
                  replay_ms_best=f"{r['best_ms']:.4f}", replay_ms_median=f"{r['median_ms']:.4f}",
                  replay_spread_10_90_ms=f"{r['spread_10_90_ms']:.4f}",
                  eager_host_ms_median=f"{e['host_median_ms']:.4f}",
                  replay_host_ms_median=f"{r['host_median_ms']:.4f}",
                  speedup_median=f"{e['median_ms'] / r['median_ms']:.3f}", card=repr(card))
            check(all(x["pixels_vs_eager"] == [0] * GRAPH_POSES for x in res),
                  f"[graph_shard] {name} at {world} ranks ({backend}): the replayed frames "
                  f"differ from the eager frames")
            check(all(x["pixels_vs_plain_stages"] == 0 and not x["plain_stage_launches"]
                      for x in res), f"[graph_shard] {name} at {world} ranks ({backend}): the "
                  f"frame through S1-S6 differs from the frame through the plain stages")
            check(all(x["launches_per_replay"] and all(el == x["launches_per_replay"]
                                                       for el in x["eager_launches"])
                      for x in res), f"[graph_shard] {name}: a replay launches "
                  f"{g['launches_per_replay']}, the eager frames {g['eager_launches']}")
            check(agree, f"[graph_shard] {name}: the ranks' compiled frames differ")
            check(all(x["entries_added"] == 1 and x["replays"] >= GRAPH_POSES for x in res),
                  f"[graph_shard] {name}: not one entry replayed at every pose")
            check(name not in graph_scene or g["collectives_in_capture"] > 0,
                  f"[graph_shard] {name}: no collective was captured into the graph")
        del ranks, dev_shards
        torch.cuda.empty_cache()

    # [shard_dryrun] ------------------------------------------------------
    t0 = time.perf_counter()
    procs = {(world, backend): subprocess.Popen(
        [sys.executable, "-m", "tpu_raytracer_torch.parallel.dryrun", "--world-size",
         str(world), "--device", "cuda:0", "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for world, backend in ((1, "nccl"), (2, "gloo"))}
    for (world, backend), proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
        phase("shard_dryrun", world=world, backend=backend, rc=proc.returncode,
              seconds=f"{time.perf_counter() - t0:.2f}", line=repr(line))
        check(proc.returncode == 0 and line.startswith("dryrun OK"),
              f"the dryrun at {world} ranks ({backend}) failed: {stderr[-2000:]}")


# The app layer's phases: frames of APP_SIZE, renders timed per mode after
# the served frames
# The big-scene route: the smallest segs=40 colonnade whose triangle rows
# pass the leaf code's 2,097,152 (26 columns: 2,163,202 triangles, more
# rows with presplit and the 8-aligned leaves), which K1-K3 cannot address.
BIG_COLUMNS = 26
BIG_SIZE = (1920, 1088)


def sample_192(dev, pose):
    """(origin, [512, 512] directions, 192 of them) of ``bench_paged.py``'s
    sample: 512x512 rays of the colonnade's camera at ``pose``, sampled at
    ``default_rng(0)`` pixels, the first 64 on the middle row and the next
    64 on the middle column (degenerate axis-aligned rays)."""
    from tpu_raytracer_torch.render import Camera, generate_rays

    p = Camera.looking(512, 512, fov_deg=65.0, pose=pose).ray_params(dev)
    o, d = generate_rays(512, 512, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    rng = np.random.default_rng(0)
    ys = rng.integers(0, 512, 192)
    xs = rng.integers(0, 512, 192)
    ys[:64] = 256
    xs[64:128] = 256
    return o, d, d[torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)]


def big_scene_phase(dev, card, paged_ctx) -> dict:
    """Phase 39, ``[big_scene]``: the colonnade past the leaf code's rows,
    compiled with the defaults, gets page tables and no resident tables,
    and the ``cuda`` and ``bvh`` backends cast it through K4
    (``traversal.cast_rays_paged_route``): the routed cast bitwise the
    forced ``paged`` cast and the plain version, its any hit the nearest
    hit's answer, 192 sampled rays against the brute cast, the frames
    (flat, ``lambert_shadow``, Whitted, a 2 spp path frame through
    ``cuda``, flat through ``bvh``) launching K4 alone, bitwise the
    ``paged`` backend's frames, with their times. Returns K4's entry of the
    kernels line on this route."""
    from tpu_raytracer_torch.accel.wide import LEAF_ROWS
    from tpu_raytracer_torch.app.scenes import scene_colonnade
    from tpu_raytracer_torch.core.vecmath import FLT_MAX
    from tpu_raytracer_torch.kernels import paged, traversal
    from tpu_raytracer_torch.render import RenderConfig, generate_rays, render_image
    from tpu_raytracer_torch.render import render_image_whitted
    from tpu_raytracer_torch.render.pipeline import render_image_path_traced
    from tpu_raytracer_torch.render.renderer import cast_rays_brute, get_cast_fn
    from tpu_raytracer_torch.utils import prng

    col = paged_ctx["col"]
    phase("big_scene_route", scene="colonnade columns=18", rows=col.num_triangles,
          needs_paging=col.needs_paging(), routed="K4" if col.needs_paging() else "K1")
    check(not col.needs_paging() and col.wide4 is not None, "the 1M colonnade was paged")

    t0 = time.perf_counter()
    big, cam = scene_colonnade(*BIG_SIZE, columns=BIG_COLUMNS, segs=40, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pg = big.paged
    attached = [k for k in ("wide4", "binary", "tlas", "paged") if getattr(big, k) is not None]
    leaves = big.node_child_a < 0
    rows = big.num_triangles
    mb = lambda *ts: f"{sum(t.numel() * t.element_size() for t in ts) / 1e6:.2f}"
    phase("big_scene", columns=BIG_COLUMNS, segs=40, triangle_rows=rows,
          real_triangles=real_tri_rows(big), leaf_rows_limit=LEAF_ROWS,
          last_leaf_start=int(big.node_leaf_start[leaves].max()),
          needs_paging=big.needs_paging(), attached=",".join(attached), pages=pg.num_pages,
          page_arity=pg.arity, top_depth=pg.top_depth, page_depth=pg.depth,
          host_build_s=f"{build_s:.2f}", tri_rec_mb=mb(big.tri_rec),
          k4_tables_mb=mb(pg.node, pg.node_base, pg.page_tri0, pg.top_code, pg.top_box),
          card=repr(card))
    check(big.needs_paging() and rows >= LEAF_ROWS and attached == ["paged"] and pg.arity == 4,
          f"the {BIG_COLUMNS}-column colonnade compiled with {attached} ({rows} rows)")

    p = cam.ray_params(dev)
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = generate_rays(*BIG_SIZE, *args)
    n_rays = d.numel() // 3
    _reset_launch_counts()
    routed = traversal.cast_rays(big, o, d)
    torch.cuda.synchronize()
    cast_launches = {k: v for k, v in _launch_counts().items() if v}
    check(cast_launches == {"K4": 1}, f"the routed cast launched {cast_launches}, not K4 once")
    forced = paged.cast_rays_paged_cuda(big, o, d)
    via_bvh = get_cast_fn("bvh")(big, o, d)
    any_hit = get_cast_fn("cuda")(big, o, d, occlusion=True)
    torch.cuda.synchronize()
    (plain, counters), plain_ms = timed(lambda: paged.cast_rays_paged_torch(big, o, d,
                                                                            stats=True))
    vs_forced = compare_hits(routed, forced)
    vs_plain = compare_hits(routed, plain)
    vs_bvh = compare_hits(via_bvh, forced)
    answer_diff = int(((any_hit.t < FLT_MAX) != (forced.t < FLT_MAX)).sum())
    o192, _, d192 = sample_192(dev, cam.pose)
    brute = cast_rays_brute(big, o192, d192, tri_chunk=1 << 16)
    far = brute_unexplained(big, o192, d192, traversal.cast_rays(big, o192, d192), brute)
    phase("big_scene_cast", rays=n_rays, routed="K4", launches=cast_launches,
          t_bitwise_diff_vs_forced=vs_forced[0], tri_diff_vs_forced=vs_forced[3],
          inst_diff_vs_forced=vs_forced[4], t_bitwise_diff_vs_plain=vs_plain[0],
          tri_diff_vs_plain=vs_plain[3], inst_diff_vs_plain=vs_plain[4],
          bvh_backend_t_bitwise_diff=vs_bvh[0], bvh_backend_tri_diff=vs_bvh[3],
          any_hit_answer_diff=answer_diff, plain_ms=f"{plain_ms:.2f}",
          hit_fraction=f"{float((routed.tri >= 0).float().mean()):.4f}",
          brute_sample_rays=192, brute_t_not_close=far[0], brute_unexplained=far[1])
    check(sum(vs_forced[i] for i in (0, 3, 4)) == 0, "the routed cast differs from K4 forced")
    check(sum(vs_plain[i] for i in (0, 3, 4)) == 0, "the routed K4 differs from its plain version")
    check(sum(vs_bvh[i] for i in (0, 3, 4)) == 0, "the bvh backend's cast differs from K4 forced")
    check(answer_diff == 0, "the routed any-hit cast's answers differ from the nearest hits")
    check(far[1] == 0, "the routed cast differs from the brute cast beyond box order")

    key = prng.PRNGKey(0, device=dev)
    frames = {
        "flat": ("cuda", lambda b: render_image(RenderConfig(*BIG_SIZE, backend=b), big, *args)),
        "lambert_shadow": ("cuda", lambda b: render_image(
            RenderConfig(*BIG_SIZE, backend=b, lighting="lambert_shadow"), big, *args)),
        "whitted": ("cuda", lambda b: render_image_whitted(RenderConfig(*BIG_SIZE, backend=b),
                                                           big, *args)),
        "path": ("cuda", lambda b: render_image_path_traced(
            RenderConfig(*BIG_SIZE, backend=b), big, *args, key, PATH_BOUNCES, PATH_SAMPLES)),
        "flat_bvh": ("bvh", lambda b: render_image(RenderConfig(*BIG_SIZE, backend=b), big,
                                                   *args)),
    }
    flat_launches = 0
    for tag, (backend, fn) in frames.items():
        _reset_launch_counts()
        img = fn(backend)
        torch.cuda.synchronize()
        n = {k: v for k, v in _launch_counts().items() if v}
        forced_img = fn("paged")
        n_px = _pixels(img, forced_img)
        best, median = best_and_median_ms(lambda: fn(backend), loops=3, n=2)
        phase("big_scene_frame", frame=tag, backend=backend, launches=n,
              pixels_vs_paged_backend=n_px, frame_ms_best=f"{best:.4f}",
              frame_ms_median=f"{median:.4f}", card=repr(card))
        check(set(_walks(n)) == {"K4"}, f"the big scene's {tag} frame launched {n}, not K4 "
              "alone of the walks")
        check(n_px == 0, f"the big scene's {tag} frame differs from the paged backend's")
        if tag == "flat":
            flat_launches = n.get("K4", 0)
    cast = lambda: traversal.cast_rays(big, o, d)
    cast_ms = min(event_ms(cast, 10) for _ in range(5))
    kernel_ms = device_ms(cast, "paged_wide_kernel")
    b = bound("K4 big scene", counters, 4, n_rays,
              (o, d, pg.node, pg.node_base, pg.page_tri0, pg.top_code, pg.top_box, *routed[:3]),
              real_tri_rows(big))
    phase("big_scene_time", card=repr(card), k4_cast_ms=f"{cast_ms:.4f}",
          k4_kernel_ms=f"{kernel_ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}")
    return {
        "name": f"K4 paged_wide_kernel on the big-scene route (the {BIG_COLUMNS}-column "
                f"colonnade, {rows} triangle rows, past the leaf code's {LEAF_ROWS}; launches: "
                "its flat frame through the cuda backend; ms, plain_ms, bound: 1920x1088 "
                "primary rays)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/paged_traverse.cu",
        "replaces": "tpu_raytracer/kernels/paged_wide.py:242",
        "launches": flat_launches,
        "max_abs_err": vs_plain[2],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **b,
    }


APP_SIZE = (1920, 1088)
APP_REPS = 3


def _best_median(times: list) -> tuple:
    times = sorted(times)
    return times[0], times[len(times) // 2]


def app_web_phase(dev, card) -> None:
    """``[app_web]``: the browser viewer (``app/web.py``) on config 4 at
    1920x1088, served on 127.0.0.1 port 0 in a thread, one viewer per mode.
    Per mode: ``GET /`` and ``GET /frame.png``; the decoded frame against
    the entry point's image at the same pose (``render_image``,
    ``render_image_whitted``, the path radiance of ``fold_in(PRNGKey(0),
    0)`` tonemapped, ``render_image_ao`` with that key), bitwise; the
    viewer renders through the compiled entry points, so that first
    request captures the mode's graph: K3's launches per replay (recorded
    by the capture) and the counts in that request (set to 0 just before,
    read just after: the warm-up frame and the capture); then the render
    ms (``render_u8``: the frame and its copy to the host) and the
    ``encode_png`` ms apart, best and median of ``APP_REPS``, and the
    whole request's ms. Path mode: a second frame
    held still adds to the sum, ``POST /drag`` restarts it (``_accum_n``
    1, 2, 1). Then ``POST /key`` and ``GET /pose``."""
    import threading
    import urllib.request

    from tpu_raytracer_torch.app.scenes import scene_instances
    from tpu_raytracer_torch.app.driver import AO_SAMPLES
    from tpu_raytracer_torch.app.web import WebViewer
    from tpu_raytracer_torch.render import (
        RenderConfig, pipeline, render_image, render_image_ao, render_image_whitted,
    )
    from tpu_raytracer_torch.render.integrators import to_u8, tonemap
    from tpu_raytracer_torch.render.pipeline import render_radiance_path_traced
    from tpu_raytracer_torch.utils import encode_png, prng
    from tpu_raytracer_torch.utils.image import decode_png

    compiled = {"primary": pipeline.compiled_render_image,
                "whitted": pipeline.compiled_render_image_whitted,
                "path": pipeline.compiled_render_radiance_path_traced,
                "ao": pipeline.compiled_render_image_ao}
    pipeline.clear_compiled()
    w, h = APP_SIZE
    scene, cam = scene_instances(w, h, device=dev)
    config = RenderConfig(cam.width, cam.height)
    key0 = prng.fold_in(prng.PRNGKey(0, device=dev), 0)
    for mode in ("primary", "whitted", "path", "ao"):
        viewer = WebViewer(scene, cam, config, mode=mode)
        p = cam.ray_params(dev)
        args = (config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        srv = viewer.make_server(host="127.0.0.1", port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        get = lambda path: urllib.request.urlopen(base + path, timeout=600).read()
        post = lambda path: urllib.request.urlopen(
            urllib.request.Request(base + path, method="POST"), timeout=600).status
        try:
            page = get("/")
            check(b"/frame.png" in page and f'width="{w}" height="{h}"'.encode() in page,
                  "the viewer's page is wrong")
            _reset_launch_counts()
            t0 = time.perf_counter()
            png = get("/frame.png")
            request_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in _launch_counts().items() if v}
            per_replay = {k: v for k, v in compiled[mode].last.launches.items()
                          if not k.endswith("_carry")}
            got = decode_png(png)
            if mode == "primary":
                want = render_image(*args)
            elif mode == "whitted":
                want = render_image_whitted(*args)
            elif mode == "path":
                rad = render_radiance_path_traced(*args, key0, viewer.path_bounces,
                                                  viewer.path_samples)
                want = to_u8(tonemap(rad / 1, config.tonemap, config.exposure))
            else:
                want = render_image_ao(*args, key0, AO_SAMPLES, viewer.ao_radius)
            n_px = _pixels(torch.from_numpy(got), want.cpu())
            sums = []
            if mode == "path":
                sums.append(viewer._accum_n)
                get("/frame.png")
                sums.append(viewer._accum_n)
                check(post("/drag?dx=40&dy=-20") == 200, "POST /drag failed")
                get("/frame.png")
                sums.append(viewer._accum_n)
            render_ms, encode_ms = [], []
            for _ in range(APP_REPS):
                t0 = time.perf_counter()
                img = viewer.render_u8()
                render_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                encode_png(img)
                encode_ms.append((time.perf_counter() - t0) * 1e3)
            check(post("/key?k=w") == 200, "POST /key failed")
            pose = json.loads(get("/pose"))
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the viewer's server thread did not stop")
        rb, rm = _best_median(render_ms)
        eb, em = _best_median(encode_ms)
        phase("app_web", card=repr(card), mode=mode, scene="config4", size=f"{w}x{h}",
              pixels_vs_entry_point=n_px, launches_per_frame=per_replay,
              counts_in_request=launches, entries=len(compiled[mode].entries),
              accum_n=sums or None, request_ms=f"{request_ms:.2f}",
              render_ms_best=f"{rb:.2f}", render_ms_median=f"{rm:.2f}",
              encode_png_ms_best=f"{eb:.2f}", encode_png_ms_median=f"{em:.2f}",
              png_bytes=len(png), frames=pose["frames"], spp=pose["spp"])
        check(n_px == 0, f"the {mode} viewer's frame differs from the entry point's in {n_px} "
              "pixels")
        want_k3 = {"primary": 1, "whitted": 6, "ao": 1 + AO_SAMPLES}.get(mode)
        check(launches.get("K3", 0) >= 1 and per_replay.get("K3", 0) >= 1
              and (want_k3 is None or per_replay["K3"] == want_k3)
              and len(compiled[mode].entries) == 1,
              f"the {mode} frame launched {per_replay} per replay, not K3 "
              f"{want_k3 or 'at least once'} ({len(compiled[mode].entries)} entries)")
        check(mode != "path" or sums == [1, 2, 1],
              f"the path sum counted {sums}, not [1, 2, 1] (held, held, dragged)")
        check(len(pose["pose"]) == 6 and pose["frames"] == 1 + APP_REPS + 2 * (mode == "path"),
              f"GET /pose gave {pose}")


def app_interactive_phase(dev, card) -> None:
    """``[app_interactive]``: the terminal viewer's loop
    (``run_interactive``) on the flagship at 1920x1088 with scripted keys
    ``wwjd``: 5 frames, the last bitwise ``render_image`` at the pose the
    keys reach (``apply_key`` from the camera's start), one graph (the
    compiled ``render_image``) captured once and replayed 5 times, one K1
    launch per replay, the counters moved by the warm-up frame and the
    capture alone, each frame's render ms (host clock to a synchronize);
    then 3 frames of ``zz`` in path mode: the frame bitwise the port's sum
    of 3 one-sample radiance frames with keys split from ``PRNGKey(0)``,
    one graph replayed 3 times."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.app.scenes import scene_bunny
    from tpu_raytracer_torch.render import RenderConfig, pipeline, render_image
    from tpu_raytracer_torch.render.integrators import to_u8, tonemap
    from tpu_raytracer_torch.render.pipeline import render_radiance_path_traced
    from tpu_raytracer_torch.utils import prng

    out = os.path.join(tempfile.mkdtemp(), "interactive.png")
    pipeline.clear_compiled()
    real, frame_ms = interactive.compiled_render_image, []

    def timed_frame(*a, **k):
        t0 = time.perf_counter()
        img = real(*a, **k)
        torch.cuda.synchronize(dev)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        return img

    interactive.compiled_render_image = timed_frame
    try:
        _reset_launch_counts()
        t0 = time.perf_counter()
        last = interactive.run_interactive("bunny", *APP_SIZE, keys=iter("wwjd"), out=out,
                                           device=dev)
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in _launch_counts().items() if v}
    finally:
        interactive.compiled_render_image = real
    entry, entries = real.last, len(real.entries)
    scene, cam = scene_bunny(*APP_SIZE, device=dev)
    for k in "wwjd":
        cam.pose, _ = interactive.apply_key(cam.pose, k)
    p = cam.ray_params(dev)
    args = (RenderConfig(*APP_SIZE), scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    n_px = _pixels(torch.from_numpy(last), render_image(*args).cpu())
    best, median = _best_median(frame_ms[1:])
    phase("app_interactive", card=repr(card), scene="flagship", mode="primary", keys="wwjd",
          frames=len(frame_ms), launches=launches, launches_per_replay=entry.launches,
          replays=entry.replays, entries=entries, pixels_vs_render_image=n_px,
          first_frame_ms=f"{frame_ms[0]:.2f}", frame_ms_best=f"{best:.2f}",
          frame_ms_median=f"{median:.2f}", run_s=f"{run_s:.2f}", shot=os.path.exists(out))
    check(len(frame_ms) == 5 and entry.launches == {"K1": 1, "S1": 1, "S2": 1, "S3": 1}
          and entry.replays == 5 and entries == 1
          and launches == {"K1": 2, "S1": 2, "S2": 2, "S3": 2},
          f"the loop made {len(frame_ms)} frames in {entries} entries, {entry.replays} "
          f"replays of {entry.launches} and counts {launches}, not 5 replays of K1 1 and "
          "the counts of one warm-up frame and one capture")
    check(n_px == 0, f"the viewer's last frame differs from render_image in {n_px} pixels")

    _reset_launch_counts()
    t0 = time.perf_counter()
    path = interactive.run_interactive("bunny", *APP_SIZE, keys=iter("zz"), out=out,
                                       mode="path", device=dev)
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in _launch_counts().items() if v}
    path_entry = pipeline.compiled_render_radiance_path_traced.last
    scene, cam = scene_bunny(*APP_SIZE, device=dev)
    p = cam.ray_params(dev)
    cfg = RenderConfig(*APP_SIZE, tonemap="reinhard")
    rng, acc = prng.PRNGKey(0, device=dev), None
    for _ in range(3):
        rng, k = prng.split(rng)
        rad = render_radiance_path_traced(cfg, scene, p["K_inv"], p["D"], p["pose"],
                                          p["inv_pose"], k, max_bounces=2, samples=1)
        acc = rad if acc is None else acc + rad
    n_px = _pixels(torch.from_numpy(path), to_u8(tonemap(acc / 3, "reinhard")).cpu())
    phase("app_interactive", card=repr(card), scene="flagship", mode="path", keys="zz",
          samples_summed=3, launches=launches, launches_per_replay=path_entry.launches,
          replays=path_entry.replays, pixels_vs_sum_of_3=n_px,
          run_s=f"{run_s:.2f}")
    check(n_px == 0, f"the progressive frame differs from the sum of 3 samples in {n_px} "
          "pixels")
    check(launches.get("K1", 0) >= 3 and path_entry.launches.get("K1") == 3
          and path_entry.replays == 3,
          f"the path frames launched {launches}, {path_entry.replays} replays of "
          f"{path_entry.launches}")
    pipeline.clear_compiled()


def app_profiling_phase(dev, card) -> None:
    """``[app_profiling]``: ``trace()`` around three compiled flagship
    frames and one eager path-traced frame writes a trace file that names
    K1's kernel and holds the port's spans ``rt.frame.<n>`` (a compiled
    call), ``rt.cast`` and ``rt.sample`` (stages of the eager body; a
    replay runs no Python) (up to three traces: the profiler now and then
    drops a trace's device activity, and each miss is printed)."""
    from tpu_raytracer_torch.app.scenes import scene_bunny
    from tpu_raytracer_torch.render import RenderConfig, pipeline
    from tpu_raytracer_torch.utils import prng
    from tpu_raytracer_torch.utils.profiling import trace

    scene, cam = scene_bunny(*APP_SIZE, device=dev)
    p = cam.ray_params(dev)
    args = (RenderConfig(cam.width, cam.height), scene, p["K_inv"], p["D"], p["pose"],
            p["inv_pose"])
    key = prng.PRNGKey(7, device=dev)
    frame = lambda: pipeline.compiled_render_image(*args)
    frame()
    names = set()
    for attempt in range(3):  # a trace now and then comes back without its kernels
        with trace(tempfile.mkdtemp(), device=dev) as d:
            for _ in range(3):
                frame()
            pipeline.render_image_path_traced(*args, key, 1, 1)
            torch.cuda.synchronize(dev)
        files = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".pt.trace.json")]
        text = ""
        if len(files) == 1:
            with open(files[0]) as f:
                text = f.read()
        events = []
        with contextlib.suppress(ValueError):
            events = json.loads(text).get("traceEvents", [])
        names = {e.get("name", "") for e in events if e.get("cat") == "user_annotation"}
        if "wide_traverse_kernel" in text:
            break
        kernels = {e.get("name", "")[:60] for e in events if e.get("cat") == "kernel"}
        phase("profiler_retry", kernel="wide_traverse_kernel", attempt=attempt,
              trace_files=len(files), trace_bytes=len(text), kernels_seen=sorted(kernels)[:8])
    frames = sorted(n for n in names if n.startswith("rt.frame."))
    spans = sorted(n for n in names if n.startswith("rt.") and n not in frames)
    phase("app_profiling", card=repr(card), trace_files=len(files), trace_bytes=len(text),
          traced_frames=3, attempts=attempt + 1, names_k1="wide_traverse_kernel" in text,
          frame_spans=frames, spans=spans)
    pipeline.clear_compiled()
    check(len(files) == 1 and "wide_traverse_kernel" in text,
          f"the trace in {d} does not name wide_traverse_kernel ({len(files)} files)")
    check(len(frames) == 3 and {"rt.bind", "rt.replay", "rt.clone", "rt.cast",
                                "rt.sample"} <= set(spans),
          f"the trace in {d} holds the spans {frames + spans}, not three rt.frame.<n> with "
          "rt.bind, rt.replay, rt.clone, rt.cast and rt.sample")


def app_driver_phase(dev, card) -> None:
    """``[app_driver]``: ``driver.run("demo", frames=2)``: out.png decoded
    against ``overlay_fps`` of the frame it returns at the FPS it burnt in
    (the bare frame where OpenCV does not import)."""
    from tpu_raytracer_torch.app import driver
    from tpu_raytracer_torch.utils import overlay_fps
    from tpu_raytracer_torch.utils.image import decode_png

    try:
        import cv2  # noqa: F401
        case = "labelled (OpenCV)"
    except ImportError:
        case = "unlabelled (no OpenCV)"
    fps = []
    driver.overlay_fps = lambda im, f: fps.append(f) or overlay_fps(im, f)
    try:
        out = os.path.join(tempfile.mkdtemp(), "out.png")
        img = driver.run("demo", *APP_SIZE, frames=2, out=out, device=dev)
    finally:
        driver.overlay_fps = overlay_fps
    with open(out, "rb") as f:
        saved = torch.from_numpy(decode_png(f.read()))
    n_px = _pixels(saved, torch.from_numpy(overlay_fps(img.numpy(), fps[-1])))
    n_bare = _pixels(saved, img)
    phase("app_driver", card=repr(card), case=case, fps=f"{fps[-1]:.2f}",
          pixels_vs_overlay=n_px, pixels_vs_bare_frame=n_bare)
    check(n_px == 0, f"out.png differs from overlay_fps of the last frame in {n_px} pixels")
    check((n_bare > 0) == case.startswith("labelled"), "the label is missing or unexpected")


def examples_phase(card) -> None:
    """``[examples]``: each ``examples/torch/*.py --device cuda`` in its own
    process, all started together (``05_multichip`` on two gloo ranks of
    this card), each exiting 0 and writing its PNG, each rendering through
    its compiled entry point (the frame times an example prints)."""
    import re
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(root, "examples", "torch")
    env = dict(os.environ, TMPDIR=tempfile.mkdtemp())
    procs = {}
    for name in sorted(f for f in os.listdir(folder) if f.endswith(".py")):
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.join(folder, name), "--device", "cuda"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root))
    check(len(procs) == 6, f"{len(procs)} examples, not 6")
    for name, (t0, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        seconds = time.perf_counter() - t0
        m = re.search(r"(\S*example_torch_\w+\.png)", stdout)
        written = bool(m) and os.path.exists(m.group(1))
        phase("examples", card=repr(card), example=name, rc=proc.returncode,
              wall_s=f"{seconds:.2f}", png=m.group(1) if m else None, written=written,
              frames=re.findall(r"frame \d+: ([\d.]+) ms", stdout),
              last_line=repr(stdout.strip().splitlines()[-1] if stdout.strip() else ""))
        check(proc.returncode == 0 and written, f"{name} failed: {stderr[-2000:]}")


def bench_scripts_phase(card) -> None:
    """``[bench_scripts]``: ``python -m tpu_raytracer_torch.bench_all bunny
    instances`` (one process per config), every line with every key;
    ``python -m tpu_raytracer_torch.bench_paged --columns 6``, its lines
    with K4's and K5's t close to the brute cast's on every sampled ray
    and no difference of K6's that box order does not explain."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    keys = {"config", "resolution", "frame_ms", "fps", "mrays_per_s", "card"}
    for cmd, tag in ((["tpu_raytracer_torch.bench_all", "bunny", "instances"], "bench_all"),
                     (["tpu_raytracer_torch.bench_paged", "--columns", "6"], "bench_paged")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                              timeout=900, cwd=root)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        phase("bench_scripts", card=repr(card), script=tag, rc=proc.returncode,
              wall_s=f"{time.perf_counter() - t0:.2f}",
              lines=json.dumps(lines, separators=(",", ":")))
        check(proc.returncode == 0, f"{tag} failed: {proc.stderr[-2000:]}")
        if tag == "bench_all":
            check(len(lines) == 2 and all(set(ln) == keys for ln in lines),
                  f"bench_all printed {lines}")
        else:
            close = [ln["paged_vs_brute_t_close"] for ln in lines
                     if "paged_vs_brute_t_close" in ln]
            # K6's sampled rays may miss a brute hit that lies outside its
            # leaf box (box order: t_unexplained_of_96 counts any other)
            unexplained = [v for ln in lines for k, v in ln.items()
                           if k.startswith("t_unexplained")]
            check(close == [True, True] and unexplained == [0, 0, 0],
                  f"bench_paged's casts are not close to the brute cast: {lines}")


def app_phases(dev, card) -> None:
    """Phases 33-38: the app layer on the card."""
    app_web_phase(dev, card)
    app_interactive_phase(dev, card)
    app_profiling_phase(dev, card)
    app_driver_phase(dev, card)
    examples_phase(card)
    bench_scripts_phase(card)


GRAPH_POSES = 3
GRAPH_TURNS = 21  # eager and replayed frames timed in turns


def _posed(args, step: int) -> tuple:
    """Camera arguments with the pose moved ``step`` small steps (its
    inverse made on the host, as ``Camera.ray_params`` makes it)."""
    from tpu_raytracer_torch.core import transforms as T

    K_inv, D, pose, _ = args
    p = pose.cpu() + step * torch.tensor([0.04, 0.04, 0.02, 0.02, 0.01, 0.0])
    return K_inv, D, p.to(pose.device), T.invert_lre(p).to(pose.device)


def _in_turns(fns: dict, turns: int) -> dict:
    """Each of ``fns`` called ``turns`` times, in turns (the order flips
    every turn): per call the CUDA-event ms around it and the host ms of
    the call itself (to its return, before the synchronize); best,
    median and the 10-90% spread of each."""
    rec = {k: ([], []) for k in fns}
    for t in range(turns):
        for k in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[k]()
            host = (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            rec[k][0].append(start.elapsed_time(end))
            rec[k][1].append(host)
    out = {}
    for k, (ev, host) in rec.items():
        ev, host = sorted(ev), sorted(host)
        n = len(ev)
        out[k] = {"best_ms": ev[0], "median_ms": ev[n // 2],
                  "spread_10_90_ms": ev[(9 * n) // 10] - ev[n // 10],
                  "host_best_ms": host[0], "host_median_ms": host[n // 2]}
    return out


def graph_phase(dev, card, flagship, config4, paged_ctx, path_ctx) -> None:
    """``[graph]``: the compiled entry points (``render/pipeline.py``
    ``compiled_*``, ``render/compiled.py``), each static config captured
    once as a CUDA graph and replayed. Per case: one eager frame under
    ``torch.cuda.set_sync_debug_mode("error")`` (what it finds: a host
    sync would break the capture), then the compiled frame at
    ``GRAPH_POSES`` poses (launch counts set to 0 just before, read just
    after), each bitwise the eager frame at that pose (the AOVs bit for
    bit), the launches of a replay (recorded at the capture) those of the
    eager frame, one new entry per case. Config 4 then moves an instance
    (``update_instance``: its rows and TLAS) and the path frame takes a
    new key: the same graph replays. A scene of the same shapes with
    other tables (config 4's albedos halved) gets an entry of its own and
    renders its own frame. The benchmark (``python3 -m rtbench``) times
    the replayed frames and their stages."""
    import dataclasses

    from tpu_raytracer_torch.render import Camera, RenderConfig, pipeline
    from tpu_raytracer_torch.render.compiled import launch_counts
    from tpu_raytracer_torch.scene import MeshInstance
    from tpu_raytracer_torch.utils import prng

    fw, fh = SLICE_SIZE
    flag_scene, flag_args = flagship
    inst4, args4 = config4
    wide_sc = paged_ctx["casts"]["K4"][0]
    col5 = path_ctx["col"]
    p5 = Camera.looking(PATH_SIZE, PATH_SIZE, fov_deg=65.0,
                        pose=path_ctx["poses"][0]).ray_params(dev)
    args5 = (p5["K_inv"], p5["D"], p5["pose"], p5["inv_pose"])
    key = prng.PRNGKey(0, device=dev)
    path = (key, PATH_BOUNCES, PATH_SAMPLES)
    # case: (entry point, config, scene, camera args, extra args, launches of
    # one frame but the carrying kernels', which K1's and K3's counts include)
    cases = {
        "flagship_flat": ("render_image", RenderConfig(fw, fh), flag_scene, flag_args, (),
                          {"K1": 1}),
        "flagship_shadow": ("render_image", RenderConfig(fw, fh, lighting="lambert_shadow"),
                            flag_scene, flag_args, (), {"K1": 2}),
        "config4_whitted": ("render_image_whitted", RenderConfig(fw, fh), inst4, args4, (),
                            {"K3": 6}),
        "config4_ao": ("render_image_ao", RenderConfig(fw, fh), inst4, args4,
                       (key, AO_SAMPLES), {"K3": 1 + AO_SAMPLES}),
        "config4_aovs": ("render_aovs", RenderConfig(fw, fh), inst4, args4, (), {"K3": 1}),
        "config5_path_cuda": ("render_image_path_traced",
                              RenderConfig(PATH_SIZE, PATH_SIZE, backend="cuda"), col5, args5,
                              path, {"K1": 3}),
        "config5_path_bvh": ("render_image_path_traced",
                             RenderConfig(PATH_SIZE, PATH_SIZE, backend="bvh"), col5, args5,
                             path, {"K2": 3}),
        "colonnade_paged": ("render_image", RenderConfig(fw, fh, backend="paged"), wide_sc,
                            paged_ctx["args"], (), {"K4": 1}),
        "colonnade_paged_major": ("render_image", RenderConfig(fw, fh, backend="paged_major"),
                                  wide_sc, paged_ctx["args"], (), {"K6": 1, "K6_plan": 1}),
    }
    pipeline.clear_compiled()
    for case, (name, config, sc, args, extra, want_launches) in cases.items():
        eager, frame = getattr(pipeline, name), getattr(pipeline, "compiled_" + name)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager(config, sc, *args, *extra)
            syncs = "none"
        except RuntimeError as e:
            syncs = repr(str(e).splitlines()[0][:160])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        n0 = len(frame.entries)
        _reset_launch_counts()
        diffs, eager_launches, captured, first = [], [], None, None
        for step in range(GRAPH_POSES):
            a = _posed(args, step)
            got = frame(config, sc, *a, *extra)
            torch.cuda.synchronize()
            if captured is None:  # the warm-up frame and the capture
                captured = {k: v for k, v in launch_counts().items() if v}
                first = got
            before = launch_counts()
            want = eager(config, sc, *a, *extra)
            torch.cuda.synchronize()
            after = launch_counts()
            eager_launches.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
            diffs.append(_pixels(got, want))
        # the same frame through the plain stages: no S1-S6 launch
        s0 = _stage_counts()
        with plain_stages():
            plain_frame = eager(config, sc, *_posed(args, 0), *extra)
        torch.cuda.synchronize()
        vs_plain = _pixels(first, plain_frame)
        plain_launches = {k: v - s0[k] for k, v in _stage_counts().items() if v != s0[k]}
        entry = frame.last
        entries = len(frame.entries) - n0
        more = {}
        if case == "config4_whitted":
            moved = MeshInstance(int(sc.inst_mesh[0]), int(sc.inst_material[0]))
            moved.pose = np.array([0.3, -0.2, 0.1, 0.5, 0.0, 0.0], np.float32)
            moved_sc = sc.update_instance(0, moved)
            got = frame(config, moved_sc, *args)
            more["update_instance_same_entry"] = frame.last is entry
            more["update_instance_pixels_vs_eager"] = _pixels(got, eager(config, moved_sc, *args))
            more["update_instance_changed_pixels"] = _pixels(got, frame(config, sc, *args))
            # a scene of the same shapes with other tables: an entry of its own
            other = dataclasses.replace(sc, mat_albedo=sc.mat_albedo * 0.5)
            got = frame(config, other, *args)
            more["new_scene_new_entry"] = frame.last is not entry
            more["new_scene_pixels_vs_its_eager"] = _pixels(got, eager(config, other, *args))
            more["new_scene_pixels_vs_old_scene"] = _pixels(got, frame(config, sc, *args))
        if case == "config5_path_cuda":
            key2 = prng.PRNGKey(1, device=dev)
            got = frame(config, sc, *args, key2, *extra[1:])
            more["new_key_same_entry"] = frame.last is entry
            more["new_key_pixels_vs_eager"] = _pixels(got, eager(config, sc, *args, key2,
                                                                 *extra[1:]))
            more["new_key_changed_pixels"] = _pixels(got, frame(config, sc, *args, *extra))
        main = {k: v for k, v in entry.launches.items() if not k.endswith("_carry")}
        phase("graph", card=repr(card), case=case, entry=f"compiled_{name}",
              size=f"{config.width}x{config.height}", backend=config.backend,
              sync_debug=syncs, pixels_vs_eager=diffs, pixels_vs_plain_stages=vs_plain,
              plain_stage_launches=plain_launches, launches_per_replay=entry.launches,
              eager_launches=eager_launches[0], counts_at_capture=captured,
              replays=entry.replays, entries_added=entries,
              capture_s=f"{entry.capture_s:.3f}", **more)
        check(syncs == "none", f"{case}: the eager frame synchronized with the host: {syncs}")
        check(diffs == [0] * GRAPH_POSES, f"{case}: the replayed frames differ from the eager "
              f"frames in {diffs} pixels")
        check(vs_plain == 0 and not plain_launches,
              f"{case}: the frame through S1-S6 differs from the frame through the plain "
              f"stages in {vs_plain} pixels (their launches: {plain_launches})")
        # every frame casts its camera's rays (S1 once) and takes their
        # attributes (S2; once in a primary frame); the primary frames shade
        # them (S3 once)
        primary = name == "render_image"
        stages_ok = (main.get("S1") == 1 and main.get("S3", 0) == int(primary)
                     and (main.get("S2") == 1 if primary else main.get("S2", 0) >= 1))
        check(all(el == entry.launches for el in eager_launches)
              and _walks(main) == want_launches and stages_ok,
              f"{case}: a replay launches {entry.launches}, the eager frames "
              f"{eager_launches}, expected {want_launches} and the frame stages")
        check(entries == 1 and entry.replays >= GRAPH_POSES,
              f"{case}: {entries} entries for {GRAPH_POSES} poses")
        if case == "config4_whitted":
            check(more["update_instance_same_entry"]
                  and more["update_instance_pixels_vs_eager"] == 0
                  and more["update_instance_changed_pixels"] > 0,
                  f"{case}: update_instance was not replayed by the captured graph: {more}")
            check(more["new_scene_new_entry"] and more["new_scene_pixels_vs_its_eager"] == 0
                  and more["new_scene_pixels_vs_old_scene"] > 0,
                  f"{case}: a new scene of the same shapes did not render its own frame: {more}")
        if case == "config5_path_cuda":
            check(more["new_key_same_entry"] and more["new_key_pixels_vs_eager"] == 0
                  and more["new_key_changed_pixels"] > 0, f"{case}: a new key: {more}")

    pipeline.clear_compiled()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_casts():
    """The ``bvh`` and ``cuda`` backends on the kernels' plain versions, on
    the rays' own device, for every cast the integrators and pipeline make."""
    from tpu_raytracer_torch.kernels import binary, tlas, traversal
    from tpu_raytracer_torch.render import integrators, pipeline, renderer, shade

    real = renderer.get_cast_fn
    cuda_plain = _plain_router(traversal, tlas)

    def plain(backend, want_normals=False, t_max=None):
        bound = {} if t_max is None else {"t_max": t_max}
        if backend == "bvh":
            return functools.partial(binary.cast_rays_binary_torch, **bound)
        if backend == "cuda":
            return functools.partial(cuda_plain, want_normals=want_normals, **bound)
        return real(backend, want_normals, t_max)

    modules = (renderer, integrators, pipeline, shade)
    saved = [m.get_cast_fn for m in modules]
    for m in modules:
        m.get_cast_fn = plain
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.get_cast_fn = f


def _plain_router(traversal, tlas):
    """``traversal.cast_rays`` with the kernels' plain versions in place
    of the kernels, on the rays' own device, carrying what the kernels
    would carry (``traversal.carry_fields``)."""
    def cast(scene, origin, directions, occlusion=False, want_normals=False, carry=None,
             t_max=traversal.BIG):
        bounded = t_max < traversal.BIG  # a bounded cast carries nothing
        uv, n = traversal.carry_fields(scene, directions, occlusion, want_normals,
                                       False if bounded else carry)
        if scene.num_instances >= 2 and scene.tlas is not None:
            return tlas.cast_rays_tlas_torch(scene, origin, directions, occlusion,
                                             carry_uv=uv, carry_n=n)
        return traversal.cast_rays_wide_torch(scene, origin, directions, occlusion,
                                              carry_uv=uv, carry_n=n, t_max=t_max)

    return cast


# f32 operations of the frame stages' per-ray code, counted from
# kernels/csrc/frame.cuh (an add, multiply, divide, negation, compare, min
# or max counts one, and so does each call of sqrtf, rsqrtf, atanf, sinf,
# cosf or powf): euler2quat 30 (3 halves, 6 sinf/cosf, 4 lanes of 5 and a
# negation), quat_rot 42, normalize 9;
OPS_QUAT, OPS_ROT, OPS_NORM = 30, 42, 9
#   S1 per pixel: K_inv 15, radius 4, atanf 1, the polynomial 12, thetad 1,
#   the scale 4, the swap 1, two normalize, euler2quat, quat_rot;
OPS_S1 = 15 + 4 + 1 + 12 + 1 + 4 + 1 + 2 * OPS_NORM + OPS_QUAT + OPS_ROT
#   S2 per ray: two euler2quat, the object ray (two quat_rot, 9), uv 12, the
#   location (6 and a quat_rot), the normal (a quat_rot, 3 and normalize),
#   4 compares and selects; the redo adds the plane (22) and the
#   barycentric rows (62), the carry the plane point (7) and, without u and
#   v, the rows; vertex normals 19;
OPS_S2 = 2 * OPS_QUAT + 2 * OPS_ROT + 9 + 12 + 6 + OPS_ROT + OPS_ROT + 3 + OPS_NORM + 4
OPS_S2_BRANCH = {"redo": 22 + 62, "uv_n": 7, "uv": 7, "n": 7 + 62}
OPS_S2_VNORM = 19
#   S3 per ray: the texel 8, the clamps 4, the colour 9, and per mode the
#   light (normalize, the cosine 5, its clamp 2; the shadow select 2;
#   Blinn-Phong's view, half vector and lobe 34).
OPS_S3 = 8 + 4 + 9
OPS_S3_MODE = {"flat": 0, "lambert": OPS_NORM + 7, "lambert_shadow": OPS_NORM + 9,
               "blinn_phong": OPS_NORM + 7 + 34}
#   S4 per ray, f32: each uniform's subtract, scale, shift and clamp 4; the
#   cosine sample (r, phi, cosf, sinf, x, y, z's three, the sign, a's
#   three, b 2, t 7, the bitangent 4, d 15) 41 and normalize; the lobe's
#   uniform 4.
OPS_S4_F32 = 2 * 4 + 41 + OPS_NORM
OPS_S4_LOBE_F32 = 4
#   S5 per ray: the sky term 6 and its select 3, the clamp 2, 1 - refl 1,
#   the local term and its sum 15, the throughput 6, refl > 0 1, the
#   reflection (dot 5, the doubling 1, 6) 12 and normalize, the origin 6,
#   the nearest texel 8.
OPS_S5 = 9 + 2 + 1 + 15 + 6 + 1 + 12 + OPS_NORM + 6 + 8
#   S6 per ray: the sky term 6 and its select 3, the emission sum 6, the
#   throughput 3, the mirror (dot 5, the doubling 1, 6) 12, the blend 10
#   and normalize, the lobe's dot 5 and two compares, the origin 6; NEE's
#   term adds 9.
OPS_S6 = 9 + 6 + 3 + 12 + 10 + OPS_NORM + 7 + 6
# uint32 operations of one threefry2x32 hash (kernels/csrc/frame.cuh): the
# first key injection 2, 20 rounds of add, rotate (one funnel shift) and
# xor, 5 injections of 2 adds; a uniform adds the xor of the two words, the
# shift and the or of the exponent
OPS_HASH = 2 + 20 * 3 + 5 * 2
OPS_UNIFORM_INT = OPS_HASH + 3
# the H100 SXM's int32 rate: 132 SMs x 64 INT32 lanes at the 1,980 MHz
# boost clock (NVIDIA's Hopper white paper and data sheet)
INT32_OPS_S = 132 * 64 * 1.98e9
# the JAX functions S1-S6 replace (XLA fuses them; no Pallas kernel)
FRAME_REPLACES = {"S1": "tpu_raytracer/render/camera.py:113",
                  "S2": "tpu_raytracer/render/renderer.py:232",
                  "S3": "tpu_raytracer/render/shade.py:385",
                  "S4": "tpu_raytracer/render/integrators.py:274",
                  "S5": "tpu_raytracer/render/integrators.py render_whitted",
                  "S6": "tpu_raytracer/render/integrators.py render_path_traced"}
FRAME_KERNEL_NAMES = {"S1": "frame_raygen_kernel", "S2": "frame_attrs_kernel",
                      "S3": "frame_shade_kernel", "S4": "frame_sample_kernel",
                      "S5": "frame_whitted_shade_kernel", "S6": "frame_path_bounce_kernel"}


def _stage_counts() -> dict:
    """Launches of S1-S6 by kernel name."""
    from tpu_raytracer_torch.render.compiled import launch_counts

    return {k: v for k, v in launch_counts().items() if k.startswith("S")}


def _walks(launches: dict) -> dict:
    """The traversal kernels' part of a launch count (K1-K6 and K6's
    plan), without the frame stages S1-S6."""
    return {k: v for k, v in launches.items() if not k.startswith("S")}


@contextlib.contextmanager
def plain_stages():
    """Raygen, hit attributes, the primary shade, the sample draws, the
    Whitted shade and the path bounce through their plain versions
    (``generate_rays_torch``, ``hit_attributes_torch``,
    ``shade_primary_torch``, ``sample_cosine_torch``,
    ``whitted_shade_torch``, ``path_bounce_torch``) for every caller of the
    routers, on the rays' own device: no S1-S6 launch."""
    import importlib

    from tpu_raytracer_torch.kernels import frame
    from tpu_raytracer_torch.render import camera, integrators, renderer, shade

    plain = {"generate_rays": camera.generate_rays_torch,
             "hit_attributes": renderer.hit_attributes_torch,
             "shade_primary": shade.shade_primary_torch,
             "sample_cosine": integrators.sample_cosine_torch,
             "whitted_shade": integrators.whitted_shade_torch,
             "path_bounce": integrators.path_bounce_torch}
    saved = []
    for mod in frame.ROUTER_MODULES:
        m = importlib.import_module(f"tpu_raytracer_torch.{mod}")
        for name, fn in plain.items():
            if hasattr(m, name):
                saved.append((m, name, getattr(m, name)))
                setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _diff_elems(a, b) -> int:
    """Elements of two tensors (or tuples of tensors) that differ, floats
    bit for bit; a shape or dtype mismatch counts every element."""
    if isinstance(a, tuple):
        return sum(_diff_elems(x, y) for x, y in zip(a, b, strict=True))
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.dtype == torch.float32:
        a, b = _bits(a), _bits(b)
    return int((a != b).sum())


def _max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(_max_abs(x, y) for x, y in zip(a, b, strict=True))
    if not a.is_floating_point():
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return float((a.double() - b.double()).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def _s2_bytes(scene, origin, d, hit, branch: str) -> int:
    """Bytes S2 must move on these rays: the per-ray inputs and outputs
    once, and each triangle row and instance record the rays name once."""
    from tpu_raytracer_torch.kernels import frame

    r = d.numel() // 3
    per_ray = 12 + 12 + 49 + (12 if origin.dim() > 1 else 0)
    per_ray += 8 if hit.u is not None else 0
    per_ray += 12 if hit.n is not None else 0
    row = {"redo": 48 + 24 + 4, "uv_n": 24 + 4, "uv": 12 + 24 + 4, "n": 36 + 24 + 4}[branch]
    row += 40 if scene.tri_vnorm is not None else 0
    rows = int(torch.unique(hit.tri.clamp(min=0)).numel())
    inst = sum(t.numel() * t.element_size() for t in frame.attr_tables(scene)[9:])
    return r * per_ray + rows * row + inst + 12


def _s3_bytes(scene, attrs, mode: str) -> int:
    """Bytes S3 must move on these rays: the inputs its mode reads and the
    u8 output once, each material row the rays name and each texel the
    nearest filter fetches once."""
    from tpu_raytracer_torch.render.shade import _c_mod

    r = attrs.hit.numel()
    per_ray = 1 + 8 + 3 + (12 if mode != "flat" else 0) + (1 if mode == "lambert_shadow" else 0)
    per_ray += 12 if mode == "blinn_phong" else 0
    per_ray += 8 if scene.has_textures else 0
    mats = torch.unique(attrs.material)
    return r * per_ray + mats.numel() * (12 + 12) + _nearest_texel_bytes(scene, attrs)


def _nearest_texel_bytes(scene, attrs, rays=None) -> int:
    """Bytes of the atlas words the nearest filter fetches at ``rays``
    (default every ray), each once."""
    from tpu_raytracer_torch.render.shade import _c_mod

    if not scene.has_textures:
        return 0
    m = attrs.material.reshape(-1).long()
    start, w, h = scene.mat_tex_start[m], scene.mat_tex_w[m], scene.mat_tex_h[m]
    uv = attrs.uv.reshape(-1, 2)
    tx = torch.clamp(_c_mod((uv[:, 0] * w.float()).to(torch.int32), w), min=0)
    ty = torch.clamp(_c_mod(((1.0 - uv[:, 1]) * h.float()).to(torch.int32), h), min=0)
    idx = torch.clamp(start, min=0) + ty * w + tx
    keep = start >= 0 if rays is None else (start >= 0) & rays.reshape(-1)
    return int(torch.unique(idx[keep]).numel()) * 4


def _s5_bytes(scene, attrs, state, last: bool) -> int:
    """Bytes S5 needs on one bounce, each once: every ray's hit flag, its
    state written (and read past the first bounce, ``state`` None) and, but
    at the last bounce, its next ray; the material and light term of the
    live rays (active and hit), their uv where textured, the direction,
    location and normal of those that bounce on (a mirror) and the
    direction of the misses under a sky map; each material row (albedo,
    texture start and size, reflectivity, emission) the live rays name and
    each texel they fetch."""
    r = attrs.hit.numel()
    active = torch.ones_like(attrs.hit) if state is None else state[2]
    live = active & attrs.hit
    m = attrs.material
    on = live & (scene.mat_reflectivity[m] > 0.0)
    textured = live & (scene.mat_tex_start[m] >= 0) if scene.has_textures else live & False
    count = lambda mask: int(mask.sum())
    nbytes = r * (1 + 25 + (0 if state is None else 25) + (0 if last else 24))
    nbytes += count(live) * (8 + 4) + count(textured) * 8 + count(on) * 36
    if scene.has_sky:
        nbytes += count(active & ~attrs.hit) * 12
    mats = int(torch.unique(m[live]).numel())
    return nbytes + mats * (12 + 12 + 4 + 4) + _nearest_texel_bytes(scene, attrs, live)


def _frame_bound(ops: int, nbytes: int) -> dict:
    t_ops, t_bytes = ops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by, "library_ms": None,
            "mbytes": nbytes / 1e6, "gflop": ops / 1e9}


# [frame_kernels]' S3 configs per set: (mode, texture filter, point lights,
# directional light on)
FRAME_POINT_LIGHTS = (((0.0, 2.0, 2.0), 4.0), ((1.5, -1.0, 2.5), 6.0))
_MODES4 = tuple((m, "nearest", 0, True) for m in ("flat", "lambert", "lambert_shadow",
                                                  "blinn_phong"))
FRAME_SHADE_CONFIGS = {
    "flagship": _MODES4,
    "config4": _MODES4 + (("lambert", "nearest", 2, True), ("lambert_shadow", "nearest", 2, True),
                          ("blinn_phong", "nearest", 1, True),
                          ("lambert_shadow", "nearest", 2, False)),
    "cube": (("flat", "nearest", 0, True), ("lambert", "nearest", 0, True),
             ("flat", "bilinear", 0, True), ("lambert", "trilinear", 0, True)),
    "fisheye_demo": (("flat", "nearest", 0, True), ("lambert_shadow", "nearest", 0, True),
                     ("flat", "bilinear", 0, True), ("flat", "trilinear", 0, True),
                     ("lambert", "trilinear", 2, True), ("lambert_shadow", "bilinear", 2, True),
                     ("blinn_phong", "trilinear", 1, True)),
}


def frame_kernels_phase(dev, card, main_launches: dict) -> list:
    """``[frame_kernels]``: S1 (raygen), S2 (hit attributes) and S3
    (primary shade) against their plain versions, every field bit for bit
    on every ray, misses included, on the flagship (K1 carrying n, and the
    redo), config 4 (K3 carrying u, v and n, the redo, and the reflection
    rays' per-ray origins), the textured cube (config 1's recipe at
    1088x1088), the demo with its sky map under the reference fisheye
    calibration, each with ``exact_math`` on and off and S2 in both normal
    modes; S3 in the configs of ``FRAME_SHADE_CONFIGS``: every mode, the
    three texture filters, the sky map, point lights with and without
    their shadows and without the directional light. Then each kernel's
    device ms on the flagship beside its bound and its plain version's ms.
    Returns the kernels line's entries, with the launches of the main
    path's frame (``main_launches``)."""
    from tpu_raytracer_torch.app.scenes import (
        build_demo_scene, scene_bunny, scene_cube, scene_instances,
    )
    from tpu_raytracer_torch.core.vecmath import normalize
    from tpu_raytracer_torch.kernels import tlas, traversal
    from tpu_raytracer_torch.render import Camera, reference_calibration, shade
    from tpu_raytracer_torch.render.camera import generate_rays, generate_rays_torch
    from tpu_raytracer_torch.render.integrators import PointLight, _reflect
    from tpu_raytracer_torch.render.renderer import hit_attributes, hit_attributes_torch
    from tpu_raytracer_torch.render.sorted_cast import park_dead_rays

    fw, fh = SLICE_SIZE
    bunny, bcam = scene_bunny(fw, fh, device=dev)
    inst4, cam4 = scene_instances(fw, fh, device=dev)
    cube, ccam = scene_cube(fh, device=dev)
    from tpu_raytracer_torch.scene import procgen

    demo = build_demo_scene()
    demo.set_sky(procgen.sky_gradient_texture())
    demo = demo.compile(dev)
    K, D = reference_calibration(fw, fh)
    dcam = Camera(fw, fh, K, D, pose=np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32))
    lights = tuple(PointLight(pos, power) for pos, power in FRAME_POINT_LIGHTS)
    sets = {"flagship": (bunny, bcam, traversal.cast_rays_cuda),
            "config4": (inst4, cam4, tlas.cast_rays_tlas_cuda),
            "cube": (cube, ccam, traversal.cast_rays_cuda),
            "fisheye_demo": (demo, dcam, tlas.cast_rays_tlas_cuda)}
    max_err = {"S1": 0.0, "S2": 0.0, "S3": 0.0}
    all_diffs = {}
    for name, (sc, cam, cast) in sets.items():
        p = cam.ray_params(dev)
        args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
        for exact in (True, False):
            diffs, misses = {}, None
            s0 = _stage_counts()
            o, d = generate_rays(cam.width, cam.height, *args, exact=exact)
            po, pd = generate_rays_torch(cam.width, cam.height, *args, exact=exact)
            torch.cuda.synchronize()
            diffs["S1"] = _diff_elems((o, d), (po, pd))
            max_err["S1"] = max(max_err["S1"], _max_abs(d, pd))
            # (origin, directions, hit record) of each cast S2 takes
            hits = {"carried": (o, d, cast(sc, o, d, want_normals=True)),
                    "redo": (o, d, cast(sc, o, d, carry=False))}
            if name == "config4":
                a = hit_attributes(sc, o, d, hits["carried"][2], exact)
                rd = normalize(_reflect(d, a.normal), exact=exact)
                ro, rd = park_dead_rays(a.location + rd * shade.SHADOW_EPS, rd, a.hit)
                hits["reflection_carried"] = (ro, rd, cast(sc, ro, rd, want_normals=True))
                hits["reflection_redo"] = (ro, rd, cast(sc, ro, rd, carry=False))
            # misses among the rays S2 and S3 take (config 4's primary rays
            # hit everywhere, its reflection rays do not)
            misses = sum(int((h.tri < 0).sum()) for _, _, h in hits.values())
            attrs = None
            for tag, (ho, hd, h) in hits.items():
                for nm in ("reference", "inverse_transpose"):
                    got = hit_attributes(sc, ho, hd, h, exact, nm)
                    want = hit_attributes_torch(sc, ho, hd, h, exact, nm)
                    torch.cuda.synchronize()
                    diffs[f"S2_{tag}_{nm}"] = _diff_elems(tuple(got), tuple(want))
                    max_err["S2"] = max(max_err["S2"], _max_abs(tuple(got), tuple(want)))
                    if tag == "carried" and nm == "reference":
                        attrs = got
            for mode, filt, n_lights, directional in FRAME_SHADE_CONFIGS[name]:
                light = shade.DEFAULT_LIGHT_DIRECTION if directional else None
                kw = dict(mode=mode, exact=exact, directions=d, tex_filter=filt,
                          point_lights=lights[:n_lights])
                got = shade.shade_primary(sc, attrs, light, **kw)
                want = shade.shade_primary_torch(sc, attrs, light, **kw)
                torch.cuda.synchronize()
                tag = f"S3_{mode}_{filt}_{n_lights}pl{'' if directional else '_nodir'}"
                diffs[tag] = _diff_elems(got, want)
                max_err["S3"] = max(max_err["S3"], _max_abs(got, want))
            ds = {k: _stage_counts()[k] - v for k, v in s0.items()}
            phase("frame_kernels", set=name, size=f"{cam.width}x{cam.height}", exact=exact,
                  instances=sc.num_instances, textured=sc.has_textures, misses=misses,
                  carried=",".join(k for k in ("u", "n") if getattr(hits["carried"][2], k)
                                   is not None), launches=ds,
                  diffs=json.dumps(diffs, separators=(",", ":")))
            check(misses > 0 or name == "cube", f"[frame_kernels] {name}: no miss to hold")
            # S2: each hit record in both normal modes, and config 4's
            # primary attributes that start the reflection rays
            want_s2 = len(hits) * 2 + (name == "config4")
            check(ds["S1"] == 1 and ds["S2"] == want_s2
                  and ds["S3"] == len(FRAME_SHADE_CONFIGS[name]),
                  f"[frame_kernels] {name}: the routers launched {ds}")
            all_diffs[(name, exact)] = diffs
            check(not any(diffs.values()), f"[frame_kernels] {name} exact={exact}: the kernels "
                  f"differ from their plain versions: {diffs}")

    # times on the flagship, its frame's inputs: S1 on the camera, S2 on
    # K1's carried hit record, S3 flat (the flagship's) on its attributes
    p = bcam.ray_params(dev)
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = generate_rays(fw, fh, *args)
    h = traversal.cast_rays_cuda(bunny, o, d)
    attrs = hit_attributes(bunny, o, d, h)
    branch = "n" if h.n is not None and h.u is None else ("uv_n" if h.u is not None else "redo")
    runs = {
        "S1": (lambda: generate_rays(fw, fh, *args),
               lambda: generate_rays_torch(fw, fh, *args),
               _frame_bound(fw * fh * OPS_S1, fw * fh * 12 + 76)),
        "S2": (lambda: hit_attributes(bunny, o, d, h),
               lambda: hit_attributes_torch(bunny, o, d, h),
               _frame_bound(fw * fh * (OPS_S2 + OPS_S2_BRANCH[branch]),
                            _s2_bytes(bunny, o, d, h, branch))),
        "S3": (lambda: shade.shade_primary(bunny, attrs),
               lambda: shade.shade_primary_torch(bunny, attrs),
               _frame_bound(fw * fh * (OPS_S3 + OPS_S3_MODE["flat"]),
                            _s3_bytes(bunny, attrs, "flat"))),
    }
    sources = {"S1": "raygen: primary ray directions, one thread per pixel",
               "S2": f"hit attributes (the {branch} branch, as the flagship's flat frame "
                     "takes it), one thread per ray",
               "S3": "primary shade (flat, the flagship's), one thread per ray"}
    entries = []
    for k, (fn, plain, b) in runs.items():
        ms = device_ms(fn, FRAME_KERNEL_NAMES[k])
        plain_ms = min(event_ms(plain, 5) for _ in range(3))
        phase("frame_kernels_time", kernel=k, card=repr(card), ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.6f}",
              bound_by=b["bound_by"], share_of_bound=f"{b['bound_ms'] / ms:.4f}",
              mbytes=f"{b['mbytes']:.3f}", gflop=f"{b['gflop']:.4f}")
        entries.append({
            "name": f"{k} {FRAME_KERNEL_NAMES[k]} ({sources[k]}; no Pallas counterpart: "
                    "replaces the XLA-fused stage; launches: the flagship frame; ms, bound "
                    "and plain_ms: the flagship at 1920x1088)",
            "route": "cuda",
            "source": "tpu_raytracer_torch/kernels/csrc/frame.cu",
            "replaces": FRAME_REPLACES[k],
            "launches": main_launches[k],
            "max_abs_err": max_err[k],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "library_ms": None,
        })
    return entries


def _sample_bound(rays: int, draws: int, nbytes: int, lobe: bool) -> dict:
    """S4's bound on ``rays`` rays of ``draws`` draws: the larger of its
    uint32 hash operations over the card's int32 rate, its f32 operations
    over the f32 rate and ``nbytes`` over the bandwidth, each stated."""
    hashes = 2 + int(lobe)
    t_int = rays * draws * hashes * OPS_UNIFORM_INT / INT32_OPS_S * 1e3
    t_f32 = rays * draws * (OPS_S4_F32 + OPS_S4_LOBE_F32 * lobe) / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    by = max((t_int, "int32 operations"), (t_f32, "f32 operations"), (t_bytes, "bytes"))
    return {"bound_ms": by[0], "bound_by": by[1], "int_ms": t_int, "f32_ms": t_f32,
            "bytes_ms": t_bytes, "mbytes": nbytes / 1e6, "gops_int": rays * draws * hashes
            * OPS_UNIFORM_INT / 1e9, "library_ms": None}


def sample_kernel_phase(dev, card, scene, origin, dirs, args) -> list:
    """``[sample_kernel]``: S4 (``kernels/frame.py sample_cosine_cuda``)
    against its plain chain (``render/integrators.py sample_cosine_torch``:
    ``utils/prng.py``'s fold_in and uniform and ``_cosine_sample``, eager
    ops on the card), directions and lobe uniforms bit for bit, misses
    included, with ``exact_math`` on and off: AO's draws (the flagship's
    normals at 1920x1088, chains (0,) and (7,)), the batched path tracer's
    (bounce 0: the normals expanded over 2 samples with stride 0; bounce 1:
    a contiguous batch; with the lobe uniforms), the sequential one's chain
    (1, 2) and the basis' edge normals (n.z = +1, -1, -0.0, +0.0, the zero
    normal of a miss); one launch a call. Then S4's launches in an eager AO
    frame (one a sample) and path frame (one a bounce before the tail), and
    ``[frame_kernels_time]`` rows for an AO draw and a path draw at
    1920x1088: device ms beside the bound (``_sample_bound``) and the plain
    chain's ms. Returns the kernels line's entry."""
    from tpu_raytracer_torch.kernels import traversal
    from tpu_raytracer_torch.render import (
        RenderConfig, hit_attributes, render_image_ao, render_image_path_traced,
    )
    from tpu_raytracer_torch.render.integrators import (
        sample_cosine, sample_cosine_torch,
    )
    from tpu_raytracer_torch.utils import prng

    h = traversal.cast_rays_cuda(scene, origin, dirs, want_normals=True)  # AO's primary cast
    normal = hit_attributes(scene, origin, dirs, h).normal
    misses = int((h.tri < 0).sum())
    edges = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.6, 0.8, -0.0],
                          [0.8, -0.6, 0.0], [0.0, 0.0, 0.0], [-0.0, 0.0, -0.0]], device=dev)
    batch = normal[None].expand((PATH_SAMPLES,) + normal.shape)
    # (normals, chain, lobe) of each call site
    cases = {"ao_s0": (normal, (0,), False), "ao_s7": (normal, (7,), False),
             "path_bounce0_expanded": (batch, (0,), True),
             "path_bounce1_contiguous": (batch.contiguous(), (1,), True),
             "path_sequential": (normal, (1, 2), True),
             "edges": (edges.expand(4, 6, 3), (5,), True)}
    key = prng.PRNGKey(2 ** 40 + 12345, device=dev)
    diffs, launches = {}, {}
    for exact in (True, False):
        for tag, (n, chain, lobe) in cases.items():
            before = _stage_counts()["S4"]
            got = sample_cosine(key, chain, n, exact, lobe)
            launches[tag] = _stage_counts()["S4"] - before
            want = sample_cosine_torch(key, chain, n, exact, lobe)
            torch.cuda.synchronize()
            if not lobe:
                got, want = (got,), (want,)
            diffs[f"{tag}_{'exact' if exact else 'q_rsqrt'}"] = _diff_elems(got, want)
    phase("sample_kernel", size=f"{dirs.shape[1]}x{dirs.shape[0]}", misses=misses,
          stride_of_expanded_batch=batch.stride(0), launches=launches,
          diffs=json.dumps(diffs, separators=(",", ":")))
    check(misses > 0, "[sample_kernel] no miss among the flagship's rays")
    check(all(v == 1 for v in launches.values()), f"[sample_kernel] launches {launches}")
    check(not any(diffs.values()), f"[sample_kernel] S4 differs from its plain chain: {diffs}")

    fw, fh = dirs.shape[1], dirs.shape[0]
    frame_key = prng.PRNGKey(3, device=dev)
    frames = {"ao": lambda: render_image_ao(RenderConfig(fw, fh), scene, *args, frame_key,
                                            AO_SAMPLES, 1.0),
              "path": lambda: render_image_path_traced(RenderConfig(fw, fh), scene, *args,
                                                       frame_key, PATH_BOUNCES, PATH_SAMPLES)}
    per_frame = {}
    for tag, fn in frames.items():
        _reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        per_frame[tag] = _stage_counts()["S4"]
    phase("sample_kernel", frame_launches=per_frame)
    check(per_frame == {"ao": AO_SAMPLES, "path": PATH_BOUNCES},
          f"[sample_kernel] S4 launches a frame {per_frame}, not one a draw")

    rays = fw * fh
    runs = {"ao_draw": (lambda: sample_cosine(key, (0,), normal, True),
                        lambda: sample_cosine_torch(key, (0,), normal, True),
                        _sample_bound(rays, 1, rays * (12 + 12) + 16, False)),
            "path_draw": (lambda: sample_cosine(key, (0,), batch, True, True),
                          lambda: sample_cosine_torch(key, (0,), batch, True, True),
                          _sample_bound(rays, PATH_SAMPLES, rays * 12
                                        + PATH_SAMPLES * rays * (12 + 4) + 16, True))}
    times = {}
    for tag, (fn, plain, b) in runs.items():
        ms = device_ms(fn, FRAME_KERNEL_NAMES["S4"])
        plain_ms = min(event_ms(plain, 3) for _ in range(3))
        times[tag] = (ms, plain_ms, b)
        phase("frame_kernels_time", kernel="S4", draw=tag, card=repr(card), ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.6f}",
              bound_by=b["bound_by"], int32_ops_ms=f"{b['int_ms']:.6f}",
              f32_ops_ms=f"{b['f32_ms']:.6f}", bytes_ms=f"{b['bytes_ms']:.6f}",
              share_of_bound=f"{b['bound_ms'] / ms:.4f}", mbytes=f"{b['mbytes']:.3f}",
              gops_int32=f"{b['gops_int']:.4f}")
    ms, plain_ms, b = times["ao_draw"]
    pms, pplain, pb = times["path_draw"]
    return [{
        "name": f"S4 {FRAME_KERNEL_NAMES['S4']} (the path tracer's and AO's sample stage: "
                "threefry, uniform and the cosine sample, one thread per ray, the key derived "
                "once a block; no Pallas counterpart: replaces the XLA-fused draws; launches: "
                f"an AO frame of {AO_SAMPLES} samples, a path frame {PATH_BOUNCES}; ms, bound "
                f"and plain_ms: one AO draw at {fw}x{fh}; a path draw of {PATH_SAMPLES} "
                f"samples with the lobe {pms:.4f} ms, bound {pb['bound_ms']:.4f} ms, plain "
                f"{pplain:.4f} ms)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/frame.cu",
        "replaces": FRAME_REPLACES["S4"],
        "launches": per_frame["ao"],
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }]


def whitted_shade_phase(dev, card) -> list:
    """``[whitted_shade]``: S5 (``kernels/frame.py whitted_shade_cuda``)
    against its plain version (``render/integrators.py
    whitted_shade_torch``, eager ops on the card), every output bit for
    bit, misses and parked rays included, with ``exact_math`` on and off:
    the three bounces of config 4's Whitted frame at 1920x1088 (the first
    with no state in, the last with no rays out; the flat sky, nearest
    texels) and of the demo under its sky map with trilinear texels (which
    a bounce samples bilinear) and its materials made mirrors; one launch
    a call. Then its launches in an eager and a compiled Whitted frame (one
    a bounce), and a ``[frame_kernels_time]`` row for config 4's first
    bounce: device ms beside the bound (``_s5_bytes`` over the bandwidth)
    and the plain version's ms. Returns the kernels line's entry."""
    import dataclasses

    from tpu_raytracer_torch.app.scenes import build_demo_scene, scene_instances
    from tpu_raytracer_torch.kernels import tlas
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, pipeline, reference_calibration,
        render_image_whitted,
    )
    from tpu_raytracer_torch.render.integrators import (
        _direct_illumination, whitted_shade, whitted_shade_torch,
    )
    from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION
    from tpu_raytracer_torch.scene import procgen

    fw, fh = SLICE_SIZE
    inst4, cam4 = scene_instances(fw, fh, device=dev)
    demo = build_demo_scene()
    demo.set_sky(procgen.sky_gradient_texture())
    demo = demo.compile(dev)
    k = demo.mat_albedo.shape[0]
    demo = dataclasses.replace(demo, mat_reflectivity=torch.tensor(
        [(0.8, 0.5, 0.0)[i % 3] for i in range(k)], device=dev))
    K, D = reference_calibration(fw, fh)
    dcam = Camera(fw, fh, K, D, pose=np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32))
    sets = {"config4": (inst4, cam4, "nearest"), "sky_demo": (demo, dcam, "trilinear")}

    def bounce_inputs(sc, o, d, exact):
        h = tlas.cast_rays_tlas_cuda(sc, o, d, want_normals=True)
        attrs = hit_attributes(sc, o, d, h, exact)
        illum = _direct_illumination(sc, tlas.cast_rays_tlas_cuda, attrs,
                                     DEFAULT_LIGHT_DIRECTION, (), exact, True, clamp_floor=0.4)
        return attrs, illum

    diffs, launches, counts = {}, {}, {}
    timed = None
    for name, (sc, cam, filt) in sets.items():
        p = cam.ray_params(dev)
        for exact in (True, False):
            o, d = generate_rays(fw, fh, p["K_inv"], p["D"], p["pose"], p["inv_pose"],
                                 exact=exact)
            state = None
            for bounce in range(3):
                attrs, illum = bounce_inputs(sc, o, d, exact)
                last = bounce == 2
                want = whitted_shade_torch(sc, d, attrs, illum, state, exact, filt, last)
                mine = None if state is None else tuple(x.clone() for x in state)
                before = _stage_counts()["S5"]
                got = whitted_shade(sc, d, attrs, illum, mine, exact, filt, last)
                torch.cuda.synchronize()
                tag = f"{name}_{'exact' if exact else 'q_rsqrt'}_b{bounce}"
                launches[tag] = _stage_counts()["S5"] - before
                diffs[tag] = _diff_elems(got[0], want[0]) + (
                    0 if last else _diff_elems(got[1], want[1]))
                counts[tag] = (int((~attrs.hit).sum()), int((~want[0][2]).sum()))
                if name == "config4" and exact and bounce == 0:
                    timed = (sc, d, attrs, illum)
                state = want[0]
                if not last:
                    o, d = want[1]
    phase("whitted_shade", size=f"{fw}x{fh}", launches=launches,
          misses_and_parked=json.dumps(counts, separators=(",", ":")),
          diffs=json.dumps(diffs, separators=(",", ":")))
    check(all(v == 1 for v in launches.values()), f"[whitted_shade] launches {launches}")
    check(not any(diffs.values()), f"[whitted_shade] S5 differs from its plain version: {diffs}")
    # config 4's primary rays hit everywhere; its reflection rays miss
    check(all(sum(counts[f"{name}_exact_b{b}"][0] for b in range(3)) > 0 for name in sets),
          "[whitted_shade] a frame without a miss")

    p4 = cam4.ray_params(dev)
    args4 = (RenderConfig(fw, fh), inst4, p4["K_inv"], p4["D"], p4["pose"], p4["inv_pose"])
    _reset_launch_counts()
    img = render_image_whitted(*args4)
    torch.cuda.synchronize()
    eager = {k: v for k, v in _stage_counts().items() if v}
    pipeline.clear_compiled()
    replay = pipeline.compiled_render_image_whitted(*args4)
    entry = pipeline.compiled_render_image_whitted.last
    phase("whitted_shade", eager_stage_launches=eager, compiled_launches=entry.launches,
          nodes=entry.nodes, pixels_vs_eager=int((replay != img).any(-1).sum()))
    check(eager == {"S1": 1, "S2": 3, "S5": 3}, f"[whitted_shade] an eager frame launched {eager}")
    check(entry.launches == {"K3": 6, "K3_carry": 3, "S1": 1, "S2": 3, "S5": 3},
          f"[whitted_shade] the compiled entry launches {entry.launches}")
    check(torch.equal(replay, img), "[whitted_shade] the replay differs from the eager frame")
    pipeline.clear_compiled()

    sc, d, attrs, illum = timed
    b = _frame_bound(fw * fh * OPS_S5, _s5_bytes(sc, attrs, None, False))
    fn = lambda: whitted_shade(sc, d, attrs, illum)
    plain = lambda: whitted_shade_torch(sc, d, attrs, illum)
    ms = device_ms(fn, FRAME_KERNEL_NAMES["S5"])
    plain_ms = min(event_ms(plain, 5) for _ in range(3))
    phase("frame_kernels_time", kernel="S5", bounce="config4_first", card=repr(card),
          ms=f"{ms:.6f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.6f}",
          bound_by=b["bound_by"], share_of_bound=f"{b['bound_ms'] / ms:.4f}",
          mbytes=f"{b['mbytes']:.3f}", gflop=f"{b['gflop']:.4f}")
    return [{
        "name": f"S5 {FRAME_KERNEL_NAMES['S5']} (one Whitted bounce's shade: the sky, the "
                "texel, the radiance and throughput sums and the parked reflected rays, one "
                "thread per ray; no Pallas counterpart: replaces the XLA-fused shade body; "
                f"launches: the config 4 Whitted frame; ms, bound and plain_ms: its first "
                f"bounce at {fw}x{fh})",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/frame.cu",
        "replaces": FRAME_REPLACES["S5"],
        "launches": entry.launches["S5"],
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }]


def _s6_bytes(scene, attrs, state, illum, period: int, tail: bool) -> int:
    """Bytes S6 needs on one call, each once: every ray's state written
    (and read past the first bounce, ``state`` None) and, but in the tail,
    its next ray; the hit flag of every one of the ``period`` rows; the rows
    of the live rays (active and hit: location, normal, direction,
    material, uv where textured), each row once, with their S4 sample and
    lobe uniform and NEE's term where given; the direction of the misses
    under a sky map; each material row (albedo, reflectivity, emission,
    roughness) the live rays name. The tail: every ray's any-hit t, its
    active flag and radiance read and the radiance written, the throughput
    of the active misses (and their direction under a sky map)."""
    from tpu_raytracer_torch.core.vecmath import FLT_MAX

    active = torch.ones_like(attrs.t, dtype=torch.bool) if state is None else state[2]
    r = active.numel()
    count = lambda mask: int(mask.sum())
    sky = 12 if scene.has_sky else 0
    if tail:
        miss = active & (attrs.t >= FLT_MAX)
        return r * (4 + 1 + 12 + 12) + count(miss) * (12 + sky)
    live = active & attrs.hit
    rows = live.reshape(-1, period).any(0)
    row = 12 + 12 + 12 + 8 + (8 if scene.has_textures else 0)
    nbytes = r * ((0 if state is None else 25) + 25 + 24) + period * 1 + count(rows) * row
    nbytes += count(live) * (16 + (4 if illum is not None else 0))
    nbytes += count(active & ~attrs.hit) * sky
    return nbytes + int(torch.unique(attrs.material[live]).numel()) * (12 + 12)


def path_bounce_phase(dev, card, ctx) -> list:
    """``[path_bounce]``: S6 (``kernels/frame.py path_bounce_cuda``)
    against its plain version (``render/integrators.py path_bounce_torch``,
    eager ops on the card, its draws S4's as the kernel's are), the state
    and the next rays bit for bit, misses and parked rays included, with
    ``exact_math`` on and off: the bounces of config 5's 2-sample path frame
    at 1920x1088 at the fly-through's first pose (the first on the primary
    rows expanded over the samples, the second per ray, the fast tail on
    the any-hit cast; with NEE's light term three full bounces); one
    launch a call. Then its launches in an eager and a compiled path frame
    at PATH_SIZE (three a frame), and ``[frame_kernels_time]`` rows for the
    first bounce, the second and the tail at 1920x1088: device ms (the L2
    flushed before each launch) beside the bound (``_s6_bytes`` over the
    bandwidth) and the plain version's ms.
    Returns the kernels line's entry."""
    import math

    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, generate_rays, hit_attributes, pipeline, render_image_path_traced,
    )
    from tpu_raytracer_torch.render.integrators import (
        _direct_illumination, path_bounce, path_bounce_torch,
    )
    from tpu_raytracer_torch.render.renderer import get_cast_fn, occlusion_cast_fn
    from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION
    from tpu_raytracer_torch.utils import prng

    col, poses = ctx["col"], ctx["poses"]
    fw, fh = SLICE_SIZE
    cam = Camera.looking(fw, fh, fov_deg=65.0, pose=poses[0])
    p = cam.ray_params(dev)
    cast, occ = get_cast_fn("cuda", want_normals=True), occlusion_cast_fn("cuda")
    key = prng.PRNGKey(2 ** 31 + 29, device=dev)
    bc = lambda x: x[None].expand((PATH_SAMPLES,) + x.shape)
    diffs, launches, counts, timed = {}, {}, {}, {}
    for exact in (True, False):
        o, d = generate_rays(fw, fh, p["K_inv"], p["D"], p["pose"], p["inv_pose"], exact=exact)
        a0 = hit_attributes(col, o, d, cast(col, o, d), exact)
        shading = dict(exact=exact, sky_strength=1.0, light_scale=1.0 / math.pi)
        for nee in (False, True):
            state, rd, attrs = None, bc(d), type(a0)(*map(bc, a0))
            for b in range(PATH_BOUNCES + 1):
                tail = b == PATH_BOUNCES and not nee
                illum = None
                if nee:
                    illum = _direct_illumination(col, cast, attrs, DEFAULT_LIGHT_DIRECTION, (),
                                                 exact, True, occ_cast=occ, shadow_floor=0.0)
                if tail:
                    attrs = occ(col, ro, rd)
                args = (col, rd, attrs, state, key, (b,), illum)
                want = path_bounce_torch(*args, tail=tail, **shading)
                mine = None if state is None else tuple(x.clone() for x in state)
                before = _stage_counts()["S6"]
                got = path_bounce(*args[:3], mine, *args[4:], tail=tail, **shading)
                torch.cuda.synchronize()
                tag = f"{'exact' if exact else 'q_rsqrt'}{'_nee' if nee else ''}_b{b}"
                launches[tag] = _stage_counts()["S6"] - before
                diffs[tag] = _diff_elems(got[0], want[0]) + (
                    0 if tail else _diff_elems(got[1], want[1]))
                counts[tag] = int((~want[0][2]).sum())
                if exact and not nee:
                    timed[f"b{b}" if not tail else "tail"] = (args, tail)
                state = want[0]
                if not tail:
                    ro, rd = want[1]
                    attrs = hit_attributes(col, ro, rd, cast(col, ro, rd), exact)
    phase("path_bounce", size=f"{fw}x{fh}", samples=PATH_SAMPLES, launches=launches,
          parked=json.dumps(counts, separators=(",", ":")),
          diffs=json.dumps(diffs, separators=(",", ":")))
    check(all(v == 1 for v in launches.values()), f"[path_bounce] launches {launches}")
    check(not any(diffs.values()), f"[path_bounce] S6 differs from its plain version: {diffs}")
    check(max(counts.values()) > 0 and all(v < PATH_SAMPLES * fw * fh for v in counts.values()),
          f"[path_bounce] no ray parked, or a bounce with no live ray: {counts}")

    cfg = RenderConfig(PATH_SIZE, PATH_SIZE)
    pp = Camera.looking(PATH_SIZE, PATH_SIZE, fov_deg=65.0, pose=poses[1]).ray_params(dev)
    fargs = (cfg, col, pp["K_inv"], pp["D"], pp["pose"], pp["inv_pose"],
             prng.PRNGKey(1, device=dev), PATH_BOUNCES, PATH_SAMPLES)
    _reset_launch_counts()
    img = render_image_path_traced(*fargs)
    torch.cuda.synchronize()
    eager = {k: v for k, v in _stage_counts().items() if v}
    with plain_stages():
        n_plain = _pixels(img, render_image_path_traced(*fargs))
    pipeline.clear_compiled()
    replay = pipeline.compiled_render_image_path_traced(*fargs)
    entry = pipeline.compiled_render_image_path_traced.last
    phase("path_bounce", eager_stage_launches=eager, compiled_launches=entry.launches,
          nodes=entry.nodes, pixels_vs_eager=_pixels(replay, img), pixels_vs_plain=n_plain)
    want_stages = {"S1": 1, "S2": 2, "S4": PATH_BOUNCES, "S6": PATH_BOUNCES + 1}
    check(eager == want_stages, f"[path_bounce] an eager frame launched {eager}")
    check({k: v for k, v in entry.launches.items() if k.startswith("S")} == want_stages,
          f"[path_bounce] the compiled entry launches {entry.launches}")
    check(torch.equal(replay, img) and n_plain == 0,
          "[path_bounce] the replay or the plain stages' frame differs from the eager frame")
    pipeline.clear_compiled()

    rows = fw * fh
    # each timed launch finds the L2 cold, as in a frame, where casts run
    # between the bounces
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for tag, (args, tail) in timed.items():
        period = rows if tag == "b0" else PATH_SAMPLES * rows
        b = _frame_bound(PATH_SAMPLES * rows * (OPS_S6 if not tail else 9),
                         _s6_bytes(col, args[2], args[3], None, period, tail))
        fresh = lambda s: None if s is None else tuple(x.clone() for x in s)
        st = fresh(args[3])
        fn = lambda: (flush.zero_(), path_bounce(*args[:3], st, *args[4:], tail=tail,
                                                 exact=True, light_scale=1.0 / math.pi))
        plain = lambda: path_bounce_torch(*args, tail=tail, exact=True, light_scale=1.0 / math.pi)
        ms = device_ms(fn, FRAME_KERNEL_NAMES["S6"])
        plain_ms = min(event_ms(plain, 5) for _ in range(3))
        phase("frame_kernels_time", kernel="S6", bounce=f"config5_{tag}", card=repr(card),
              rays=PATH_SAMPLES * rows, rows_read=period, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b['bound_ms']:.6f}",
              bound_by=b["bound_by"], share_of_bound=f"{b['bound_ms'] / ms:.4f}",
              mbytes=f"{b['mbytes']:.3f}", gflop=f"{b['gflop']:.4f}")
        timed[tag] = (ms, plain_ms, b)
    ms, plain_ms, b = timed["b0"]
    return [{
        "name": f"S6 {FRAME_KERNEL_NAMES['S6']} (one path-tracing bounce: the sky, the surface "
                "colour, the emission, the throughput, the lobe blend and the parked next rays, "
                "one thread per ray, the primary rows read through their period; the fast "
                "tail's sky term; no Pallas counterpart: replaces the XLA-fused bounce body; "
                f"launches: a config 5 path frame; ms, bound and plain_ms: its first bounce at "
                f"{fw}x{fh}, {PATH_SAMPLES} samples; second bounce {timed['b1'][0]:.6f} ms, "
                f"tail {timed['tail'][0]:.6f} ms)",
        "route": "cuda",
        "source": "tpu_raytracer_torch/kernels/csrc/frame.cu",
        "replaces": FRAME_REPLACES["S6"],
        "launches": entry.launches["S6"],
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }]


def golden_renders(dev) -> dict:
    """{golden name: a function rendering its scene through the ``cuda``
    backend}: configs 1-4 at the sizes of their CPU goldens, each frame
    eager (``[golden_carry]`` renders them again with the carry off)."""
    from tpu_raytracer_torch.app.scenes import (
        scene_bunny, scene_cornell, scene_cube, scene_instances,
    )
    from tpu_raytracer_torch.render import (
        Camera, RenderConfig, render_image, render_image_whitted,
    )
    from tpu_raytracer_torch.scene import Material, MeshInstance, Scene, objloader, procgen

    tex = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(64, 8))
    tex.add_material(mat)
    tex.add_mesh(objloader.loads(procgen.cube_obj()))
    tex.add_mesh_instance(MeshInstance(0, 0))
    tex = tex.compile(dev)
    cube, cube_cam = scene_cube(64, device=dev)
    cam64 = Camera.looking(64, 64, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])

    def render(cam, sc):
        p = cam.ray_params(dev)
        return render_image(RenderConfig(cam.width, cam.height, backend="cuda"), sc, p["K_inv"],
                            p["D"], p["pose"], p["inv_pose"])

    out = {"config1_cube_64": lambda: render(cube_cam, cube),
           "cube_64": lambda: render(cam64, tex)}
    for gname, fn, lighting, (sc, gcam) in (
        ("config2_cornell_64", render_image, "lambert_shadow", scene_cornell(64, device=dev)),
        ("config3_bunny_96", render_image, "blinn_phong",
         scene_bunny(96, 96, subdivisions=4, device=dev)),
        ("config4_instances_whitted_64", render_image_whitted, "flat",
         scene_instances(64, 64, device=dev)),
    ):
        gp = gcam.ray_params(dev)
        out[gname] = lambda fn=fn, lighting=lighting, sc=sc, gcam=gcam, gp=gp: fn(
            RenderConfig(gcam.width, gcam.height, backend="cuda", lighting=lighting), sc,
            gp["K_inv"], gp["D"], gp["pose"], gp["inv_pose"])
    return out


def _golden_mismatch(img: torch.Tensor, name: str) -> int:
    """Pixels of ``img`` off the CPU golden ``tests/golden/<name>.npy``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                        name + ".npy")
    golden = np.load(path)
    return int((img.cpu().numpy() != golden).any(-1).sum())


if __name__ == "__main__":
    main()
