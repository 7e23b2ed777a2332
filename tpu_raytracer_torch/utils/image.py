"""Image input and output, and the FPS overlay (counterpart of
``tpu_raytracer/utils/image.py`` and of the image reads of
``tpu_raytracer/scene/material.py``).

Images are [H, W, 3] uint8 in the reference's BGR channel order; the
PNG is written as RGB (numpy and zlib) so viewers show the same colours
as the JAX package's ``cv2.imwrite``. ``read_png`` reads an image file
with ``cv2.imread(fp, cv2.IMREAD_COLOR)`` where OpenCV imports, as the
JAX package's ``Material.upload_texture`` does, so JPEG and 16-bit PNG
textures read as there. Without OpenCV it decodes with ``decode_png``,
which returns what ``cv2.imread`` returns for the PNGs it reads:
greyscale replicated to three channels, a palette looked up, alpha
dropped, channels in BGR order. It reads 8-bit, non-interlaced PNGs of
the greyscale, RGB, palette and RGBA colour types, with all five row
filters; any other format (JPEG, 16-bit or interlaced PNG, ...) raises a
``ValueError`` that names it. ``overlay_fps`` burns the FPS label into a
frame with ``cv2.putText``; without OpenCV the frame comes back
unlabelled, as the JAX package's does.
"""

from __future__ import annotations

import os
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale with alpha", 6: "RGBA"}
# the colour types read, with their bytes per pixel at 8 bits
_BYTES_PER_PIXEL = {0: 1, 2: 3, 3: 1, 6: 4}


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` [H, W, bpp] (one filter type per
    row): each byte adds a predictor from its left (a), upper (b) and
    upper-left (c) neighbours, so a pixel depends on the pixels up and to
    its left only, and every anti-diagonal r + c = d is computed at once
    from the two before it."""
    h, w, _ = raw.shape
    out = np.zeros((h + 1, w + 1, raw.shape[2]), np.int32)  # zero row and column
    raw = raw.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (raw[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 in BGR order (the module docstring
    lists what it reads). Raises ValueError on other formats and on a
    corrupt file."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG images are not supported: only PNG is read")
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length] or b"\0" * 4)
        if len(body) != length or zlib.crc32(tag + body) != crc:
            raise ValueError(f"corrupt PNG: bad {tag!r} chunk")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _BYTES_PER_PIXEL:
        name = _COLOR_NAMES.get(ctype, f"colour type {ctype}")
        raise ValueError(f"{name} PNG images are not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit {_COLOR_NAMES[ctype]} PNG images are not supported "
                         "(8-bit only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG images are not supported")
    bpp = _BYTES_PER_PIXEL[ctype]
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    if flat.size != h * (w * bpp + 1):
        raise ValueError("corrupt PNG: image data of the wrong size")
    rows = flat.reshape(h, w * bpp + 1)
    if (rows[:, 0] > 4).any():
        raise ValueError("corrupt PNG: unknown row filter")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= len(palette):
            raise ValueError("corrupt PNG: palette index out of range")
        rgb = palette[px[..., 0]]
    elif ctype == 0:
        rgb = np.repeat(px, 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def read_png(fp: str) -> np.ndarray:
    """An image file -> [H, W, 3] uint8 in BGR order: ``cv2.imread`` where
    OpenCV imports (any format it reads), else ``decode_png``. A missing
    file raises ``FileNotFoundError``; one that cannot be read raises
    ``ValueError``."""
    try:
        import cv2
    except ImportError:
        with open(fp, "rb") as f:
            return decode_png(f.read())
    if not os.path.exists(fp):
        raise FileNotFoundError(fp)
    img = cv2.imread(fp, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"OpenCV cannot read {fp}")
    return np.asarray(img, np.uint8)


def overlay_fps(img, fps: float) -> np.ndarray:
    """A copy of the frame [H, W, 3] uint8 with ``FPS: <fps>`` burnt in
    at its top left (kernel.cu:40-41) where OpenCV imports; without it the
    copy is unlabelled."""
    img = np.array(img, np.uint8)  # a writable copy: putText draws in place
    try:
        import cv2
    except ImportError:
        return img
    cv2.putText(img, f"FPS: {fps:f}", (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
    return img


def save_png(img, fp: str) -> None:
    with open(fp, "wb") as f:
        f.write(encode_png(img))
