"""Ray/triangle and ray/AABB intersection math on tensors.

Counterpart of ``tpu_raytracer/render/intersect.py``: the two-step
triangle test (plane hit, then barycentric inside test with UV weights
w*uv0 + v*uv1 + u*uv2) and the slab test returning the entry distance.
Every backend of the port (brute oracle, plain walk, CUDA kernel) uses
the same affine barycentric rows, so they agree bit for bit on u/v.
All functions broadcast over leading axes.
"""

from __future__ import annotations

import torch

from ..core.vecmath import FLT_MAX, dot

PARALLEL_EPS = 1e-6
WATERTIGHT_NUDGE = 1e-12  # absolute box out-round, applied in t-space
EDGE_EPS = 1e-3  # inclusive barycentric bound (see the JAX module)


def ray_plane_hit(origin, direction, tv0, normal):
    """Plane-hit step: (t, point, valid); valid is False where the ray is
    parallel (|denom| < PARALLEL_EPS) or the hit lies behind the origin."""
    denom = dot(direction, normal)
    parallel = torch.abs(denom) < PARALLEL_EPS
    safe_denom = torch.where(parallel, torch.ones_like(denom), denom)
    t = dot(tv0 - origin, normal) / safe_denom
    valid = ~parallel & (t >= 0.0)
    point = origin + t[..., None] * direction
    return t, point, valid


def barycentric_rows(tv0, tv1, tv2):
    """Affine barycentric rows rA, rB with u = rA.(p - v0), v = rB.(p - v0)."""
    e0 = tv2 - tv0
    e1 = tv1 - tv0
    dot00 = dot(e0, e0)
    dot01 = dot(e0, e1)
    dot11 = dot(e1, e1)
    inv_denom = 1.0 / (dot00 * dot11 - dot01 * dot01)
    ra = (dot11[..., None] * e0 - dot01[..., None] * e1) * inv_denom[..., None]
    rb = (dot00[..., None] * e1 - dot01[..., None] * e0) * inv_denom[..., None]
    return ra, rb


def barycentric_uv(origin, direction, t, tv0, tv1, tv2):
    """Barycentric (u, v) of the ray's plane point, with the offset taken
    as (origin - v0) + t*d like every other backend."""
    ra, rb = barycentric_rows(tv0, tv1, tv2)
    e2 = (origin - tv0) + t[..., None] * direction
    return dot(ra, e2), dot(rb, e2)


def bary_interp(u, v, a0, a1, a2):
    """w*a0 + v*a1 + u*a2 with w = 1 - u - v."""
    w = 1.0 - u - v
    return w[..., None] * a0 + v[..., None] * a1 + u[..., None] * a2


def point_in_triangle_uv(origin, direction, t, tv0, tv1, tv2, uv0, uv1, uv2):
    """Barycentric inside test plus UV interpolation -> (uv, inside)."""
    u, v = barycentric_uv(origin, direction, t, tv0, tv1, tv2)
    inside = (u >= -EDGE_EPS) & (v >= -EDGE_EPS) & (u + v <= 1.0 + EDGE_EPS)
    return bary_interp(u, v, uv0, uv1, uv2), inside


def ray_aabb_entry(origin, inv_direction, box_min, box_max):
    """Slab test: entry distance to an AABB, FLT_MAX on a miss. The slab
    numerators are nudged outward by WATERTIGHT_NUDGE; fmin/fmax drop
    the NaN of 0 * inf like CUDA's fminf/fmaxf."""
    tmin = (box_min - origin - WATERTIGHT_NUDGE) * inv_direction
    tmax = (box_max - origin + WATERTIGHT_NUDGE) * inv_direction
    t1 = torch.fmin(tmin, tmax)
    t2 = torch.fmax(tmin, tmax)
    far = torch.minimum(torch.minimum(t2[..., 0], t2[..., 1]), t2[..., 2])
    near = torch.maximum(torch.maximum(t1[..., 0], t1[..., 1]), t1[..., 2])
    hit = (far >= near) & (far > 0.0)
    return torch.where(hit, near, torch.full_like(near, FLT_MAX))


def safe_reciprocal(direction):
    """Componentwise 1/d with |d| < 1e-30 clamped to +-1e-30 first, so
    the reciprocal stays finite."""
    tiny = torch.full_like(direction, 1e-30)
    clamped = torch.where(direction < 0, -tiny, tiny)
    return 1.0 / torch.where(torch.abs(direction) < 1e-30, clamped, direction)
