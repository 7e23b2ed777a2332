"""One run of one cell: ``python -m rtbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.

A run is one viewer-like caller in a closed loop on one card:

  * set-up (``setup_s``, from the process's start): the configuration's
    scene description from the harness's generator (``scenes.py``), the
    port's scene (``Scene.compile("cuda")``, each BVH cached in the
    checkout), the camera path's table, then the traffic's entry
    (``entries/<entry>.py``) warmed on the run's first three frames (the
    first call builds the kernel library, where the checkout has none
    yet, and captures the graph);
  * the window: for ``--seconds``, frame i takes the pose of step
    (seed + i) of the path and, for path tracing and AO, the key
    ``fold_in(PRNGKey(seed), i)`` (span ``rtbench.pose``), calls the entry
    with those host tensors (``rtbench.call``) and waits for the card
    (``rtbench.sync``). A frame's latency runs from the call to the
    synchronize's return; the image stays on the card;
  * ``frame_ms`` is the window's length over its frames, ``frame_p95_ms``
    the nearest-rank 95th percentile of every frame's latency;
  * with ``--trace 1`` a stretch of the window (the traffic's
    ``trace_start`` and ``trace_frames``; the window lasts until it has
    ended) runs under ``torch.profiler`` and the per-layer readers
    (``metrics/``) read it;
  * after the window: the card's peak memory, the port's state freed,
    then the output check (``check.py``) and the result line.

The result is the last line of standard output, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key (``checks``). A run prints no result and
exits non-zero without a card, with fewer cards than the cell asks, without
the port in its checkout, or when ``jax``, ``jaxlib``, ``flax`` or
``tpu_raytracer`` (whole top-level names) is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_raytracer")
CACHE = ".rtbench_cache"  # the checkout's caches and the trace, at fixed paths
WARM_FRAMES = 3


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m rtbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def _power_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    import subprocess

    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"


class Context:
    """What a per-layer reader reads: the trace, the host's dispatch
    times, the cell's traffic and the count of triangles its scene
    stores (the sum over its meshes)."""

    def __init__(self, trace, dispatch_ms, traffic, triangles):
        self.trace, self.dispatch_ms = trace, dispatch_ms
        self.traffic, self.triangles = traffic, triangles


def main(argv=None, t0: float | None = None, device=None, cell=None) -> int:
    """Run a cell. Tests only: ``device`` skips the look for a card and
    runs there; ``cell`` replaces the ``spec.Cell`` the workload names."""
    t0 = time.perf_counter() if t0 is None else t0
    a = parse(argv)
    import torch

    from . import check, pose, scenes, spec, system
    from .trace import Trace, Tracer

    cell = cell or spec.Cell(a.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"rtbench: {a.workload} needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    cache = os.path.join(spec.ROOT, CACHE)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    system.import_port(spec.ROOT)
    seed = a.seed % 2 ** 63
    traffic, config = cell.traffic, cell.config

    # set-up ---------------------------------------------------------------
    desc = scenes.scene(config)
    camera = pose.CameraPath(config["camera"])
    intr = pose.intrinsics(traffic["width"], traffic["height"], config["fov_deg"])
    port = system.Frames(config, traffic, desc, device, os.path.join(cache, "bvh"))
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    for i in range(WARM_FRAMES):
        port.frame(*check.inputs(camera, intr, seed, i, port.keyed))
        sync()
    setup_s = time.perf_counter() - t0

    # the window -----------------------------------------------------------
    drawn = set(check.drawn_frames(seed, traffic))
    kept = {}
    tracer = None
    if a.trace:
        tracer = Tracer(traffic["trace_start"], traffic["trace_frames"],
                        os.path.join(cache, "trace", a.workload + ".json"))
    from torch.profiler import record_function

    latency, dispatch = [], []
    i = 0
    start = time.perf_counter()
    end = start + a.seconds
    done = start
    # a traced run's window lasts until its traced stretch has ended
    while i == 0 or done < end or (tracer is not None and not tracer.frames):
        traced = tracer is not None and tracer.active(i)
        span = record_function if traced else (lambda name: contextlib.nullcontext())
        if tracer is not None:
            tracer.before(i)
        with span("rtbench.pose"):
            inp = check.inputs(camera, intr, seed, i, port.keyed)
        t_call = time.perf_counter()
        with span("rtbench.call"):
            out = port.frame(*inp)
        t_ret = time.perf_counter()
        with span("rtbench.sync"):
            sync()
        done = time.perf_counter()
        latency.append(done - t_call)
        if not traced:
            dispatch.append((t_ret - t_call) * 1e3)
        if i in drawn:
            kept[i] = out
        if tracer is not None:
            tracer.after(i)
        i += 1
    frames, window_s = i, done - start
    kept[frames - 1] = out
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics, extra = {}, {}
    if a.trace:
        tr = Trace(tracer.path, tracer.frames)
        ctx = Context(tr, dispatch, traffic, scenes.triangle_count(desc))
        readers = spec.all_metric_readers()
        claimed = [p for r in readers.values() for p in getattr(r, "PATTERNS", ())]
        unclaimed = tr.unclaimed(claimed)
        print("[unclaimed] device_ms_per_frame=" + repr(sum(unclaimed.values())) + " kernels="
              + json.dumps(sorted(unclaimed.items(), key=lambda kv: -kv[1])[:10]), flush=True)
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_us / 1e6, "window_s": tr.window_us / 1e6}
        breakdown = tr.breakdown()
    else:
        values = {"frame_ms": window_s / frames * 1e3, "frame_p95_ms": p95(latency) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    print(f"[window] frames={frames} window_s={window_s!r} setup_s={setup_s!r} "
          f"traced_frames={tracer.frames if tracer else 0} card={_power_line(device)}", flush=True)

    # the output check, once the port's state is freed -----------------------
    port.close()
    del port, out
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.Reference(config, traffic, desc, device)
    readings = []
    for idx in sorted(kept):
        image = kept.pop(idx)
        readings.append(check.compare(image, ref.frame(*check.inputs(camera, intr, seed, idx))))
    print(f"[reference] frames={len(readings)} seconds={time.perf_counter() - t_ref!r}",
          flush=True)
    missing = sorted(drawn - set(range(frames)))
    correct, checks = check.judge(readings, missing, cell.limits)
    limits = cell.limits
    failed = len(missing) + sum(any(r[k] > limits[k] for k in check.NUMBERS) for r in readings)

    bad = forbidden_modules()
    if bad:
        print(f"rtbench: modules loaded that the port must not use: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": frames, "failed": failed, "metrics": metrics,
              "device": {**_card(device), "memory_peak_bytes": peak, **extra}}
    if a.trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} value={c['value']!r} limit={c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
