"""Camera inputs of a run: intrinsics, poses and their inverses, and the
configurations' camera paths.

The pose maths are frozen copies of the port's (``tpu_raytracer_torch/
core/transforms.py``: ``euler2rotmat``, ``rotmat2euler``, ``euler2quat``,
``apply_quat``, ``lre2homo``, ``invert_homo``, ``homo2lre``, ``apply_lre``,
``invert_lre``; ``core/vecmath.py``: ``apply_mat3``, ``invert_intrinsic``;
``render/camera.py``: ``default_intrinsics``; ``app/controls.py``:
``fly`` and ``fly_through``), so that the benchmark makes every camera
input itself and hands the same tensors to the port and to the
reference. A pose is a ``[..., 6]`` float32 tensor (x, y, z, yaw, pitch,
roll); world is y-forward, z-up, and yaw turns the view from +y toward
+x.

A camera path is a table of ``period`` poses, made once at set-up;
frame ``i`` of a run with seed ``s`` takes pose ``(s + i) % period``, so
every seed renders the same poses in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def apply_mat3(m, v):
    return _dot(m, v[..., None, :])


def euler2rotmat(euler):
    sy, cy = torch.sin(euler[..., 0]), torch.cos(euler[..., 0])
    sp, cp = torch.sin(euler[..., 1]), torch.cos(euler[..., 1])
    sr, cr = torch.sin(euler[..., 2]), torch.cos(euler[..., 2])
    row0 = torch.stack([cr * cy + sr * sp * sy, -cr * sy + sr * sp * cy, -sr * cp], -1)
    row1 = torch.stack([cp * sy, cp * cy, sp], -1)
    row2 = torch.stack([sr * cy - cr * sp * sy, -sr * sy - cr * sp * cy, cr * cp], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat2euler(rotmat):
    a = torch.clamp(rotmat[..., 1, 2], -1.0, 1.0)
    yaw = torch.atan2(rotmat[..., 1, 0], rotmat[..., 1, 1])
    pitch = torch.asin(a)
    roll = torch.atan2(-rotmat[..., 0, 2], rotmat[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def euler2quat(euler):
    sy, cy = torch.sin(euler[..., 0] * 0.5), torch.cos(euler[..., 0] * 0.5)
    sp, cp = torch.sin(euler[..., 1] * 0.5), torch.cos(euler[..., 1] * 0.5)
    sr, cr = torch.sin(euler[..., 2] * 0.5), torch.cos(euler[..., 2] * 0.5)
    return torch.stack([sy * sp * sr + cy * cp * cr, cy * sp * cr + sy * cp * sr,
                        -sy * sp * cr + cy * cp * sr, cy * sp * sr - sy * cp * cr], dim=-1)


def apply_quat(q, v):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    a = -vx * qx - vy * qy - vz * qz
    b = vx * qw + vy * qz - vz * qy
    c = vy * qw + vz * qx - vx * qz
    d = vz * qw + vx * qy - vy * qx
    return torch.stack([qw * b - qx * a - qy * d + qz * c, qw * c - qy * a - qz * b + qx * d,
                        qw * d - qz * a - qx * c + qy * b], dim=-1)


def apply_euler(euler, v):
    return apply_quat(euler2quat(euler), v)


def apply_lre(p, v):
    """World points into the pose's local frame: R(euler) (v - xyz)."""
    return apply_euler(p[..., 3:6], v - p[..., 0:3])


def _homo_bottom(top):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def lre2homo(p):
    R = euler2rotmat(p[..., 3:6])
    top = torch.cat([R, apply_mat3(R, -p[..., 0:3])[..., :, None]], dim=-1)
    return torch.cat([top, _homo_bottom(top)], dim=-2)


def homo2lre(H):
    R = H[..., 0:3, 0:3]
    shift = apply_mat3(R.transpose(-1, -2), H[..., 0:3, 3])
    return torch.cat([-shift, rotmat2euler(R)], dim=-1)


def invert_homo(H):
    R_inv = H[..., 0:3, 0:3].transpose(-1, -2)
    top = torch.cat([R_inv, apply_mat3(R_inv, -H[..., 0:3, 3])[..., :, None]], dim=-1)
    return torch.cat([top, _homo_bottom(top)], dim=-2)


def invert_lre(p):
    """Pose inverse via homogeneous matrices."""
    return homo2lre(invert_homo(lre2homo(p)))


def fly(pose, forward: float = 0.0, right: float = 0.0, up: float = 0.0):
    """Copy of ``controls.fly``: a step along the camera's local axes."""
    pose = np.asarray(pose, np.float32).copy()
    step = torch.tensor([right, forward, up], dtype=torch.float32)
    pose[0:3] = apply_lre(invert_lre(torch.from_numpy(pose)), step).numpy()
    return pose


def fly_through(start_pose, frames: int, forward_per_frame: float = 0.05,
                yaw_per_frame: float = 0.005):
    """Copy of ``controls.fly_through``: each frame a step forward, then a
    turn of the yaw."""
    pose = np.asarray(start_pose, np.float32).copy()
    for _ in range(frames):
        pose = fly(pose, forward=forward_per_frame)
        pose[3] += yaw_per_frame
        yield pose.copy()


def intrinsics(width: int, height: int, fov_deg: float):
    """(K, K_inv, D): ``default_intrinsics`` (a pinhole K whose
    horizontal field of view after the equidistant mapping is about
    ``fov_deg``), its closed-form inverse and zero distortion, float32."""
    f = (width / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    K = torch.from_numpy(np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0],
                                   [0.0, 0.0, 1.0]], np.float32))
    fx_inv = 1.0 / K[0, 0]
    fy_inv = 1.0 / K[1, 1]
    zero = torch.zeros((), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    K_inv = torch.stack([torch.stack([fx_inv, zero, -K[0, 2] * fx_inv]),
                         torch.stack([zero, fy_inv, -K[1, 2] * fy_inv]),
                         torch.stack([zero, zero, one])])
    return K, K_inv, torch.zeros(4, dtype=torch.float32)


def _forward(yaw):
    return np.sin(yaw), np.cos(yaw)


def turntable(center, radius: float, height: float, step_deg: float):
    """A camera orbiting ``center`` (x, y) at ``radius`` and ``height``,
    looking at it level, ``step_deg`` of azimuth a frame: poses
    ``[period, 6]`` with period 360 / step_deg."""
    period = int(round(360.0 / step_deg))
    yaw = np.deg2rad(step_deg) * np.arange(period)
    fx, fy = _forward(yaw)
    return np.stack([center[0] - radius * fx, center[1] - radius * fy,
                     np.full(period, height), yaw, np.zeros(period), np.zeros(period)],
                    -1).astype(np.float32)


def lap(center, height: float, forward: float, yaw_step: float):
    """The closed path that ``fly_through(pose, n, forward, yaw_step)``
    steps: a step of ``forward`` along the view, then a turn of
    ``yaw_step``, a regular polygon about ``center`` (x, y) of
    ``round(2 pi / yaw_step)`` poses. Pose k looks along yaw k * yaw_step
    from the polygon's vertex k: the centre less the apothem along the
    turn and half a step along the view."""
    period = int(round(2.0 * math.pi / yaw_step))
    yaw = yaw_step * np.arange(period)
    fx, fy = _forward(yaw)
    rx, ry = np.cos(yaw), -np.sin(yaw)  # the turn's side
    apothem = (forward / 2.0) / math.tan(yaw_step / 2.0)
    x = center[0] - apothem * rx - forward / 2.0 * fx
    y = center[1] - apothem * ry - forward / 2.0 * fy
    return np.stack([x, y, np.full(period, height), yaw, np.zeros(period), np.zeros(period)],
                    -1).astype(np.float32)


PATHS = {"turntable": turntable, "lap": lap}


class CameraPath:
    """A configuration's ``"camera"`` entry made into a table: ``pose``
    and ``inv_pose`` ``[period, 6]`` float32 on the host."""

    def __init__(self, spec: dict):
        args = {k: v for k, v in spec.items() if k != "path"}
        self.pose = torch.from_numpy(PATHS[spec["path"]](**args))
        self.inv_pose = invert_lre(self.pose)
        self.period = len(self.pose)

    def index(self, seed: int, frame: int) -> int:
        return (seed + frame) % self.period
