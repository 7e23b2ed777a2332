"""The readings a cell's check limits are set from, many seeds in one
process: ``python -m rtbench.calibrate --workload <cell> --seeds 1,2,3``.

For each seed the cell's compiled entry (built and captured once)
renders the frames a run with that seed checks: the drawn ones
(``check.drawn_frames``) and one more at an index drawn from the seed
past them, standing in for the window's last frame. Then, with the
port's state freed, the reference renders each, and so does the control
(the reference with bfloat16 geometry, in the port's place). One JSON
line per seed gives the worst frame's numbers of the port and of the
control against the reference; the last line gives, per number, the
largest reading of the port and the smallest of the control over all
seeds: the lower and the upper reading a limit lies between.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rtbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds, the first, the control renders too")
    a = ap.parse_args(argv)
    import torch

    from . import check, pose, scenes, spec, system
    from .run import CACHE

    if not torch.cuda.is_available():
        print("rtbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.Cell(a.workload)
    system.import_port(spec.ROOT)
    traffic, config = cell.traffic, cell.config
    desc = scenes.scene(config)
    camera = pose.CameraPath(config["camera"])
    intr = pose.intrinsics(traffic["width"], traffic["height"], config["fov_deg"])
    port = system.Frames(config, traffic, desc, device, os.path.join(spec.ROOT, CACHE, "bvh"))
    seeds = [int(s) % 2 ** 63 for s in a.seeds.split(",")]
    frames = {}
    t = time.perf_counter()
    for seed in seeds:
        last = traffic["check_within"] + random.Random(~seed).randrange(1000)
        for idx in check.drawn_frames(seed, traffic) + [last]:
            frames[seed, idx] = port.frame(*check.inputs(camera, intr, seed, idx, port.keyed))
        torch.cuda.synchronize(device)
    print(f"[port] frames={len(frames)} seconds={time.perf_counter() - t!r}", flush=True)
    port.close()
    del port
    torch.cuda.empty_cache()
    ref = check.Reference(config, traffic, desc, device)
    low = check.Reference(config, traffic, desc, device, "bfloat16") if a.control_seeds else None
    lower, upper = {}, {}
    for seed in seeds:
        t = time.perf_counter()
        got = {"program": [], "control": []}
        for (s, idx), image in sorted(frames.items()):
            if s != seed:
                continue
            inp = check.inputs(camera, intr, seed, idx)
            r = ref.frame(*inp)
            got["program"].append(check.compare(image, r))
            if low is not None and seeds.index(seed) < a.control_seeds:
                got["control"].append(check.compare(low.frame(*inp), r))
        line = {"seed": seed, "seconds": time.perf_counter() - t}
        for side, readings in got.items():
            if readings:
                line[side] = check.worst(readings)
        for k in check.NUMBERS:
            lower[k] = max(lower.get(k, 0.0), line["program"][k])
            if "control" in line:
                upper[k] = min(upper.get(k, float("inf")), line["control"][k])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": a.workload, "seeds": len(seeds), "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
