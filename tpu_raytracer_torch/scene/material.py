"""Material record (counterpart of ``tpu_raytracer/scene/material.py``).

A texture is a host ``[H, W, 3]`` uint8 array in the reference's BGR
channel order; ``Scene.compile`` packs it into the flat atlas.
``upload_texture`` reads one from an image file (``utils/image.py
read_png``: ``cv2.imread`` as in the JAX package where OpenCV imports,
else PNGs alone).
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

    def upload_texture(self, fp: str) -> None:
        """Load an image file as this material's texture (Material.hpp:29-43)."""
        from ..utils.image import read_png

        self.set_texture(read_png(fp))

    def set_texture(self, img: np.ndarray) -> None:
        """Attach an in-memory [H, W, 3] uint8 texture."""
        img = np.asarray(img, np.uint8)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"texture must be [H, W, 3] uint8, got {img.shape}")
        self.texture = img
