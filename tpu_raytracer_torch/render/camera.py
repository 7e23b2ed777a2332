"""Camera model and primary ray generation.

Counterpart of ``tpu_raytracer/render/camera.py``: pixel (x, y, 1) ->
K_inv -> Kannala-Brandt radial scale (theta * (1 + D1 t + ... + D4 t^4))
-> normalize -> axis swap to y-forward / z-up (x, z, -y) -> rotation by
the inverse camera pose -> normalize. The origin is one ``[3]`` tensor
shared by every ray. ``generate_rays`` routes: kernel S1 on the card,
``generate_rays_torch`` (its plain version) on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transforms as T
from ..core.vecmath import apply_mat3, invert_intrinsic, normalize


def default_intrinsics(width: int, height: int, fov_deg: float = 60.0):
    """Pinhole-ish K whose horizontal FOV after the equidistant fisheye
    mapping is about ``fov_deg``."""
    r_half = np.tan(np.deg2rad(fov_deg) / 2.0)
    f = (width / 2.0) / r_half
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )


#: The reference app's real fisheye calibration, 1920x1080.
REFERENCE_K = np.array(
    [[862.097835972576, 0.0, 998.1702383680802],
     [0.0, 862.1368447300727, 569.6759403225842],
     [0.0, 0.0, 1.0]],
    np.float32,
)
REFERENCE_D = np.array(
    [0.016233999489849514, -0.013875757716177956,
     0.03264329940126211, -0.019561619947134234],
    np.float32,
)
REFERENCE_CALIB_SIZE = (1920, 1080)


def reference_calibration(width: int = 1920, height: int = 1080):
    """The reference's fisheye K/D, K rescaled to ``width x height``."""
    rw = width / REFERENCE_CALIB_SIZE[0]
    rh = height / REFERENCE_CALIB_SIZE[1]
    K = REFERENCE_K * np.array(
        [[rw, 1.0, rw], [1.0, rh, rh], [1.0, 1.0, 1.0]], np.float64
    )
    return K.astype(np.float32), REFERENCE_D.copy()


@dataclasses.dataclass
class Camera:
    """Host-side camera; ``pose`` is an lre array."""

    width: int
    height: int
    K: np.ndarray
    D: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4, np.float32))
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6, np.float32))

    def __post_init__(self):
        self.K = np.asarray(self.K, np.float32).reshape(3, 3)
        self.D = np.asarray(self.D, np.float32).reshape(4)
        self.pose = np.asarray(self.pose, np.float32).reshape(6)
        self.K_inv = invert_intrinsic(torch.from_numpy(self.K)).numpy()

    @classmethod
    def looking(cls, width: int, height: int, fov_deg: float = 60.0, pose=None):
        cam = cls(width, height, default_intrinsics(width, height, fov_deg))
        if pose is not None:
            cam.pose = np.asarray(pose, np.float32).reshape(6)
        return cam

    def ray_params(self, device="cuda") -> dict:
        """Per-frame ray parameters as tensors on ``device``; the inverse
        pose is computed on the host per call."""
        pose = torch.from_numpy(self.pose)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
        return {
            "K_inv": f(self.K_inv),
            "D": f(self.D),
            "pose": f(pose),
            "inv_pose": f(T.invert_lre(pose)),
        }


def generate_rays(width: int, height: int, K_inv: torch.Tensor, D: torch.Tensor,
                  pose: torch.Tensor, inv_pose: torch.Tensor, exact: bool = True):
    """Primary rays for the full image on ``K_inv``'s device: (origin [3],
    directions [H, W, 3]). CUDA tensors launch kernel S1
    (``kernels/frame.py generate_rays_cuda``), CPU tensors take the plain
    version ``generate_rays_torch``."""
    if torch.as_tensor(K_inv).device.type == "cpu":
        return generate_rays_torch(width, height, K_inv, D, pose, inv_pose, exact)
    from ..kernels.frame import generate_rays_cuda

    return generate_rays_cuda(width, height, K_inv, D, pose, inv_pose, exact)


def generate_rays_torch(width: int, height: int, K_inv: torch.Tensor, D: torch.Tensor,
                        pose: torch.Tensor, inv_pose: torch.Tensor, exact: bool = True):
    """The plain version of ``generate_rays`` (and of kernel S1), on
    ``K_inv``'s device."""
    dev = K_inv.device
    x = torch.arange(width, dtype=torch.float32, device=dev).expand(height, width)
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    ph = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    direction = apply_mat3(K_inv, ph)

    a = direction[..., 0]
    b = direction[..., 1]
    radius = torch.sqrt(a * a + b * b)
    theta = torch.atan(radius)
    thetad = theta * (
        1.0
        + D[0] * theta
        + D[1] * theta ** 2
        + D[2] * theta ** 3
        + D[3] * theta ** 4
    )
    pos = radius > 0.0
    scale = torch.where(pos, thetad / torch.where(pos, radius, torch.ones_like(radius)),
                        torch.ones_like(radius))
    direction = torch.stack([scale * a, scale * b, direction[..., 2]], dim=-1)
    direction = normalize(direction, exact=exact)

    # y forward, z up in world space
    direction = torch.stack(
        [direction[..., 0], direction[..., 2], -direction[..., 1]], dim=-1
    )
    direction = T.apply_euler(T.pose_euler(inv_pose), direction)
    direction = normalize(direction, exact=exact)
    return T.pose_xyz(pose), direction
