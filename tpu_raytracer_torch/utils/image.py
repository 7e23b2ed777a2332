"""PNG output in numpy and zlib (counterpart of
``tpu_raytracer/utils/image.py``, which uses OpenCV or PIL).

Images are [H, W, 3] uint8 in the reference's BGR channel order; the
PNG is written as RGB so viewers show the same colours as the JAX
package's ``cv2.imwrite``. The FPS text overlay of the JAX driver needs
OpenCV and is not ported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img) -> bytes:
    """[H, W, 3] uint8 (BGR) -> PNG bytes (8-bit RGB, no filtering)."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8)[..., ::-1])
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def save_png(img, fp: str) -> None:
    with open(fp, "wb") as f:
        f.write(encode_png(img))
