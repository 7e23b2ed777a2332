"""Material record (counterpart of ``tpu_raytracer/scene/material.py``).

A texture is a host ``[H, W, 3]`` uint8 array in the reference's BGR
channel order; ``Scene.compile`` packs it into the flat atlas. Loading
textures from image files is not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Material:
    albedo: tuple = (1.0, 1.0, 1.0)
    roughness: float = 0.0
    metallic: float = 0.0
    illumination: float = 0.0
    reflectivity: float = 0.0
    texture: np.ndarray | None = None  # [H, W, 3] uint8

    def set_texture(self, img: np.ndarray) -> None:
        """Attach an in-memory [H, W, 3] uint8 texture."""
        img = np.asarray(img, np.uint8)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"texture must be [H, W, 3] uint8, got {img.shape}")
        self.texture = img
