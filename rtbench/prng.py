"""Frozen copy of the port's randomness (``tpu_raytracer_torch/utils/
prng.py``): threefry2x32 as ``jax.random`` computes it, in PyTorch
integer arithmetic, so that the reference draws the same numbers as the
port from the same key without importing it.

A key is an int64 tensor ``[2]`` holding two uint32 words. ``frame_key``
is the per-frame key of a run, ``fold_in(PRNGKey(seed), frame)``,
computed in Python integers on the host (the same hash, one element).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of counter words ``x1``/``x2`` under key words
    ``k1``/``k2``: tensors or Python ints, uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(g + 1) % 3]) & MASK
        x2 = (x2 + ks[(g + 2) % 3] + g + 1) & MASK
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64, device=device)


def frame_key(seed: int, frame: int) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), frame)`` as a host int64 tensor ``[2]``."""
    b1, b2 = threefry2x32(seed >> 32, seed & MASK, 0, frame & MASK)
    return torch.tensor([b1, b2], dtype=torch.int64)


def _hash(key, shape):
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], (lo >> 32).reshape(shape), (lo & MASK).reshape(shape))


def split(key, num: int = 2) -> torch.Tensor:
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], zero, zero + (int(data) & MASK))
    return torch.stack([b1, b2])


def uniform(key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32: the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    b1, b2 = _hash(key, tuple(shape))
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.zeros((), dtype=torch.float32, device=key.device)
    hi = torch.ones((), dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)
