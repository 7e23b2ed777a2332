"""MeshInstance: a posed, scaled occurrence of a mesh with a material
(counterpart of ``tpu_raytracer/scene/instance.py``). ``build_inv``
precomputes the inverse transforms on the host, through the port's own
transforms."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transforms as T


@dataclasses.dataclass
class MeshInstance:
    mesh_index: int
    material_index: int
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(6, np.float32)
    )  # lre (x, y, z, yaw, pitch, roll)
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )

    def __post_init__(self):
        self.pose = np.asarray(self.pose, np.float32).reshape(6)
        self.scale = np.asarray(self.scale, np.float32).reshape(3)

    def build_inv(self) -> dict[str, np.ndarray]:
        """Precompute the inverse transforms."""
        inv_pose = T.invert_lre(torch.from_numpy(self.pose)).numpy()
        return {
            "pose": self.pose,
            "inv_pose": inv_pose,
            "scale": self.scale,
            "inv_scale": (1.0 / self.scale).astype(np.float32),
        }
