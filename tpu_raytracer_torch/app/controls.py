"""Camera controls as pure pose functions (counterpart of
``tpu_raytracer/app/controls.py``): mouse-drag orbit, WASD-style fly and
the fly-through of BASELINE config 5. Poses are numpy ``[6]`` f32 lre
vectors (x, y, z, yaw, pitch, roll), the camera's per-frame argument.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as T


def orbit(pose: np.ndarray, dx: float, dy: float, sensitivity: float = 0.001) -> np.ndarray:
    """Mouse-drag orbit: yaw += dx * s, pitch -= dy * s."""
    pose = np.asarray(pose, np.float32).copy()
    pose[3] += dx * sensitivity
    pose[4] -= dy * sensitivity
    return pose


def fly(pose: np.ndarray, forward: float = 0.0, right: float = 0.0, up: float = 0.0) -> np.ndarray:
    """Move along the camera's local axes: the step mapped out of the
    pose's frame (``apply_lre(invert_lre(pose), step)``)."""
    pose = np.asarray(pose, np.float32).copy()
    step = torch.tensor([right, forward, up], dtype=torch.float32)
    pose[0:3] = T.apply_lre(T.invert_lre(torch.from_numpy(pose)), step).numpy()
    return pose


def fly_through(start_pose: np.ndarray, frames: int, forward_per_frame: float = 0.05,
                yaw_per_frame: float = 0.005):
    """Generator of the poses of an animated camera fly-through."""
    pose = np.asarray(start_pose, np.float32).copy()
    for _ in range(frames):
        pose = fly(pose, forward=forward_per_frame)
        pose[3] += yaw_per_frame
        yield pose.copy()
