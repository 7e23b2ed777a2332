"""Vector math on ``[..., 3]`` float32 tensors.

Counterpart of ``tpu_raytracer/core/vecmath.py``. Reductions over the
3-vector axis are written as explicit left-to-right sums (x + y) + z
rather than ``torch.sum``, so the rounding order is fixed and matches
the JAX package's three-element reductions.
"""

from __future__ import annotations

import torch

FLT_MAX = 3.4028234663852886e38  # CUDA FLT_MAX (largest f32), the miss sentinel


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of 3-vectors over the last axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def magnitude(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (``dot``'s summation order)."""
    return torch.sqrt(dot(v, v))


def q_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact fast inverse square root (0x5f3759df and one Newton
    step), through an int32 view like the JAX bitcast."""
    x = torch.as_tensor(x, dtype=torch.float32)
    i = x.view(torch.int32)
    i = 0x5F3759DF - (i >> 1)
    y = i.view(torch.float32)
    return y * (1.5 - (x * 0.5) * y * y)


def normalize(v: torch.Tensor, *, exact: bool = True) -> torch.Tensor:
    """Normalize over the last axis; ``exact=False`` uses ``q_rsqrt``."""
    sq = dot(v, v)[..., None]
    inv = torch.rsqrt(sq) if exact else q_rsqrt(sq)
    return v * inv


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant vector on ``device``, each element of ``values``
    rounded to ``dtype`` as ``torch.tensor(values, dtype=dtype)`` rounds
    it, written by fill kernels: no copy from host memory, so a frame
    that makes it can be captured in a CUDA graph."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def apply_mat3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for ``m [..., 3, 3]`` and ``v [..., 3]``, written as
    multiply-adds so no backend silently lowers the precision."""
    return dot(m, v[..., None, :])


def invert_intrinsic(K) -> torch.Tensor:
    """Closed-form inverse of a zero-skew pinhole intrinsic matrix."""
    K = torch.as_tensor(K, dtype=torch.float32)
    fx_inv = 1.0 / K[0, 0]
    fy_inv = 1.0 / K[1, 1]
    zero = torch.zeros((), dtype=torch.float32, device=K.device)
    one = torch.ones((), dtype=torch.float32, device=K.device)
    return torch.stack([
        torch.stack([fx_inv, zero, -K[0, 2] * fx_inv]),
        torch.stack([zero, fy_inv, -K[1, 2] * fy_inv]),
        torch.stack([zero, zero, one]),
    ])
