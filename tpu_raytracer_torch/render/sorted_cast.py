"""Casts of secondary rays: dead-ray parking and the secondary-cast hook.

Counterpart of ``tpu_raytracer/render/sorted_cast.py`` without the
coherence sort, which is off by default in the JAX package and not
ported yet (ROADMAP item 11): ``secondary_cast_fn`` passes the cast
through and raises if sorting is asked for.
"""

from __future__ import annotations

import torch

# Terminated-ray parking spot: an origin far outside every scene with a
# direction pointing away, so the slab test of the root's children
# rejects the ray at once: t = (box - 1e9) * 1 < 0 on every axis, so far
# < 0, a miss, with no inf or NaN anywhere. Shadow and bounce casts then
# cost in proportion to the live rays.
PARK_ORIGIN = 1.0e9
PARK_DIRECTION = (1.0, 1.0, 1.0)


def park_dead_rays(o: torch.Tensor, d: torch.Tensor, live: torch.Tensor):
    """Replace dead rays with the guaranteed-miss parked ray; live rays
    pass through unchanged. Returns per-ray ``[..., 3]`` origins and
    directions."""
    keep = live[..., None]
    park_d = torch.tensor(PARK_DIRECTION, dtype=torch.float32, device=d.device)
    return (
        torch.where(keep, o, torch.full_like(o, PARK_ORIGIN)),
        torch.where(keep, d, park_d.expand(d.shape)),
    )


def secondary_cast_fn(cast, sort_secondary: bool = False):
    """The cast for secondary (shadow and bounce) rays: ``cast`` itself.
    The coherence-sorted cast (``sort_secondary``) is not ported yet."""
    if sort_secondary:
        raise NotImplementedError(
            "coherence-sorted secondary casts (ray_sort_keys, cast_rays_sorted) "
            "are not ported yet (ROADMAP item 11)")
    return cast
