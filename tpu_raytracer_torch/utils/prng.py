"""The JAX package's randomness: threefry2x32 in PyTorch integer
arithmetic, bit-equal to ``jax.random`` (jax 0.9.0, whose default
``jax_threefry_partitionable=True`` fixes the counters below).

Counterpart of ``jax._src.prng`` (``threefry_seed``, the 20 rounds and
key schedule of ``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax._src.random._uniform``. The port draws the JAX package's streams:
the same key gives the same bits on the CPU and on the card.

This is the plain version of the path tracer's and AO's ``sample`` stage
(``render/integrators.py sample_cosine_torch``): on the card that stage
is kernel S4 (``kernels/csrc/frame.cuh``), the same hash on uint32 words
in registers, bit for bit these functions. On the card this module
remains the path of the thin lens's draws (``minval`` not 0), of the
viewers' and the sharded frames' per-frame and per-rank ``fold_in`` and
``split`` of the key, and of ``random_bits``.

A key is an explicit int64 tensor ``[2]`` (or ``[..., 2]``) holding two
uint32 words, passed in by the caller as in JAX; there is no global
generator. Words live in int64 tensors masked to 32 bits, since PyTorch's
uint32 lacks kernels on CUDA.

``split``, ``fold_in`` and ``uniform`` are the frame's ``sample`` stage
(``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from .profiling import stage

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of counter words ``x1``/``x2`` under key
    words ``k1``/``k2`` (all uint32 values in int64 tensors, broadcast
    together): 5 groups of 4 rounds, a key injection after each."""
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
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**63): the key
    words are the seed's high and low 32 bits."""
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64, device=device)


def _counters(shape, device):
    """``iota_2x32_shape``: the high and low words of the flat index."""
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return (lo >> 32).reshape(shape), (lo & MASK).reshape(shape)


def _hash(key: torch.Tensor, shape):
    hi, lo = _counters(tuple(shape), key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` keys."""
    with stage("sample"):
        b1, b2 = _hash(key, (num,))
        return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    with stage("sample"):
        zero = torch.zeros((), dtype=torch.int64, device=key.device)
        b1, b2 = threefry2x32(key[0], key[1], zero, zero + (int(data) & MASK))
        return torch.stack([b1, b2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64)."""
    b1, b2 = _hash(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled by
    ``maxval - minval`` (in f32), shifted by ``minval`` and clamped below
    at it."""
    with stage("sample"):
        bits = (random_bits(key, tuple(shape)) >> 9) | 0x3F800000
        floats = bits.to(torch.int32).view(torch.float32) - 1.0
        lo = torch.full((), minval, dtype=torch.float32, device=key.device)
        hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
        return torch.maximum(lo, floats * (hi - lo) + lo)
