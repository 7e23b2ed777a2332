"""The output check: frames of the timed path against the plain
reference (``reference.py``), and the numbers compared.

Which frames: those at indices drawn from the seed among the first
``check_within`` of the window (``check_frames - 1`` of them) and the
window's last frame, each kept on the card as the entry returned it. Once
the window has closed and the port's state is freed, the reference
renders each from the same camera inputs and key, and each pair gives:

  * ``px_off_pct``: the share of pixels, in percent, whose largest
    channel difference exceeds 1 level of 255;
  * ``mean_abs``: the mean absolute difference over every pixel and
    channel, in levels.

The run is correct where the worst frame's numbers are within the cell's
limits (``workloads/<cell>.json``) and every drawn frame was rendered.
"""

from __future__ import annotations

import random

import torch

from . import prng, reference, spec

NUMBERS = ("px_off_pct", "mean_abs")


def drawn_frames(seed: int, traffic: dict) -> list:
    """The window's frame indices drawn from ``seed`` for the check."""
    rng = random.Random(seed)
    return sorted(rng.sample(range(traffic["check_within"]), traffic["check_frames"] - 1))


def compare(image: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers of one frame against its reference."""
    diff = (image.to(torch.int16) - ref.to(torch.int16)).abs()
    return {"px_off_pct": 100.0 * (diff.amax(-1) > 1).to(torch.float64).mean().item(),
            "mean_abs": diff.to(torch.float64).mean().item()}


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in NUMBERS}


class Reference:
    """The reference's frames of one cell: its geometry built once from the
    scene description ``desc``, its frames drawn by the traffic's entry
    module (``entries/<entry>.py``)."""

    def __init__(self, config: dict, traffic: dict, desc: dict, device,
                 precision: str = "float32"):
        self.config, self.traffic, self.scene = config, traffic, desc
        self.geom = reference.Geometry.from_scene(desc, device, precision)
        self.device = torch.device(device)
        self.entry = spec.entry(traffic["entry"])

    def frame(self, K_inv, D, pose, inv_pose, key) -> torch.Tensor:
        t = self.traffic
        rays = reference.raygen(t["width"], t["height"], K_inv, D, pose, inv_pose, self.device)
        return self.entry.reference(self, rays, key, self.config, t)


def inputs(camera, intr, seed: int, frame: int, keyed: bool = True):
    """The camera inputs and key (None unless ``keyed``) of frame
    ``frame`` of a run with ``seed``: host tensors, the same for the port
    and the reference."""
    i = camera.index(seed, frame)
    _, K_inv, D = intr
    key = prng.frame_key(seed, frame) if keyed else None
    return K_inv, D, camera.pose[i], camera.inv_pose[i], key


def judge(readings: list, missing: list, limits: dict) -> tuple:
    """(correct, checks): the worst frame's numbers beside their limits,
    and the drawn frames the window never reached."""
    checks = {}
    ok = not missing and bool(readings)
    if readings:
        for k, v in worst(readings).items():
            checks[k] = {"value": v, "limit": limits[k]}
            ok = ok and v <= limits[k]
    checks["frames_checked"] = {"value": len(readings), "limit": len(readings) + len(missing)}
    return ok, checks
