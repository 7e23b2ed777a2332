"""6-DoF pose ("lre") library on float32 tensors.

Counterpart of ``tpu_raytracer/core/transforms.py``: a pose is a
``[..., 6]`` tensor ``(x, y, z, yaw, pitch, roll)``;
``apply_lre(pose, v) = R(euler) @ (v - xyz)`` maps world points into
the pose's local frame. Each formula keeps the JAX function's operation
order so results agree to the last few ulps (sin/cos/atan2 may differ
by an ulp between libraries).
"""

from __future__ import annotations

import torch

from .vecmath import apply_mat3


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def pose(x=0.0, y=0.0, z=0.0, yaw=0.0, pitch=0.0, roll=0.0, device="cpu") -> torch.Tensor:
    """An lre pose ``[6]`` f32 on ``device``."""
    return torch.tensor([x, y, z, yaw, pitch, roll], dtype=torch.float32, device=device)


def pose_xyz(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0:3]


def pose_euler(p: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) triple of a pose."""
    return p[..., 3:6]


def euler2rotmat(euler: torch.Tensor) -> torch.Tensor:
    """Euler (yaw, pitch, roll) -> 3x3 rotation."""
    euler = _f32(euler)
    sy, cy = torch.sin(euler[..., 0]), torch.cos(euler[..., 0])
    sp, cp = torch.sin(euler[..., 1]), torch.cos(euler[..., 1])
    sr, cr = torch.sin(euler[..., 2]), torch.cos(euler[..., 2])
    row0 = torch.stack([cr * cy + sr * sp * sy, -cr * sy + sr * sp * cy, -sr * cp], -1)
    row1 = torch.stack([cp * sy, cp * cy, sp], -1)
    row2 = torch.stack([sr * cy - cr * sp * sy, -sr * sy - cr * sp * cy, cr * cp], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat2euler(rotmat: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> euler (yaw, pitch, roll)."""
    a = torch.clamp(rotmat[..., 1, 2], -1.0, 1.0)
    yaw = torch.atan2(rotmat[..., 1, 0], rotmat[..., 1, 1])
    pitch = torch.asin(a)
    roll = torch.atan2(-rotmat[..., 0, 2], rotmat[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def invert_rotmat(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation inverse = transpose."""
    return rotmat.transpose(-1, -2)


def euler2quat(euler: torch.Tensor) -> torch.Tensor:
    """Euler -> quaternion stored (w, x, y, z)."""
    euler = _f32(euler)
    sy, cy = torch.sin(euler[..., 0] * 0.5), torch.cos(euler[..., 0] * 0.5)
    sp, cp = torch.sin(euler[..., 1] * 0.5), torch.cos(euler[..., 1] * 0.5)
    sr, cr = torch.sin(euler[..., 2] * 0.5), torch.cos(euler[..., 2] * 0.5)
    return torch.stack(
        [
            sy * sp * sr + cy * cp * cr,
            cy * sp * cr + sy * cp * sr,
            -sy * sp * cr + cy * cp * sr,
            cy * sp * sr - sy * cp * cr,
        ],
        dim=-1,
    )


def apply_quat(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by a (w, x, y, z) quaternion; the op order is the
    traversal kernel's ``quat_rot``."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    a = -vx * qx - vy * qy - vz * qz
    b = vx * qw + vy * qz - vz * qy
    c = vy * qw + vz * qx - vx * qz
    d = vz * qw + vx * qy - vy * qx
    return torch.stack(
        [
            qw * b - qx * a - qy * d + qz * c,
            qw * c - qy * a - qz * b + qx * d,
            qw * d - qz * a - qx * c + qy * b,
        ],
        dim=-1,
    )


def apply_euler(euler: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by euler angles via the quaternion path."""
    return apply_quat(euler2quat(euler), v)


def _homo_bottom(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def lre2homo(p: torch.Tensor) -> torch.Tensor:
    """Pose -> 4x4 homogeneous H with H @ [v; 1] = R (v - t)."""
    p = _f32(p)
    R = euler2rotmat(pose_euler(p))
    rot_shift = apply_mat3(R, -pose_xyz(p))
    top = torch.cat([R, rot_shift[..., :, None]], dim=-1)
    return torch.cat([top, _homo_bottom(top)], dim=-2)


def homo2lre(H: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous -> pose."""
    R = H[..., 0:3, 0:3]
    euler = rotmat2euler(R)
    shift = apply_mat3(invert_rotmat(R), H[..., 0:3, 3])
    return torch.cat([-shift, euler], dim=-1)


def invert_homo(H: torch.Tensor) -> torch.Tensor:
    """Invert a rigid homogeneous transform."""
    R_inv = invert_rotmat(H[..., 0:3, 0:3])
    t_inv = apply_mat3(R_inv, -H[..., 0:3, 3])
    top = torch.cat([R_inv, t_inv[..., :, None]], dim=-1)
    return torch.cat([top, _homo_bottom(top)], dim=-2)


def compose_homo(H1: torch.Tensor, H2: torch.Tensor) -> torch.Tensor:
    """Compose homogeneous transforms: ``H2 @ H1``, in f32, each entry's
    four products summed left to right."""
    return (H2[..., :, 0:1] * H1[..., 0:1, :] + H2[..., :, 1:2] * H1[..., 1:2, :]
            + H2[..., :, 2:3] * H1[..., 2:3, :] + H2[..., :, 3:4] * H1[..., 3:4, :])


def apply_lre(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Map world points into the pose's local frame: R(euler) (v - xyz)."""
    return apply_euler(pose_euler(p), v - pose_xyz(p))


def compose_lre(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Pose composition via homogeneous matrices: p1, then p2."""
    return homo2lre(compose_homo(lre2homo(p1), lre2homo(p2)))


def invert_lre(p: torch.Tensor) -> torch.Tensor:
    """Pose inverse via homogeneous matrices."""
    return homo2lre(invert_homo(lre2homo(p)))
