"""Casts of secondary rays: dead-ray parking and the coherence sort.

Counterpart of ``tpu_raytracer/render/sorted_cast.py``. Secondary rays
(cosine-sampled path bounces above all) arrive in pixel order with
scattered origins and directions. ``cast_rays_sorted`` casts them in the
order of a coherence key — origin Morton code (top 15 bits), direction
octant (3 bits), origin Morton code (low 15 bits) — and scatters the
hits back to ray order, so that neighbouring threads of a kernel walk
similar nodes. The sort is a permutation: every ray's hit is the one the
unsorted cast gives, because the kernels walk each ray on its own.

``secondary_cast_fn`` sorts for the ``cuda`` backend (K1 and K3, the
counterpart of the JAX ``pallas`` route that sorts) when asked, and
passes every other backend through, as the JAX package does. The JAX
package's sort-key and sort-secondary knobs are TPU
experiments and are not ported: the default key only, and the choice is
the ``sort_secondary`` argument.

No caller of the port sorts by default: every secondary cast (Whitted's,
the shadow rays', the path tracer's bounces and any-hit tail, the
sharded frames') takes its rays in wavefront order, as the stage before
it writes them. On bounce batches the key is the direction octant alone
(parked rays sit at ``PARK_ORIGIN``, so the batch's bounds put every
live ray's Morton code at 0), and on an H100 the keys, argsort, gathers
and scatter of a 1080p path frame's two sorted casts (2 spp) cost ~3 ms
of device time, several times what K1 gains from walking the rays in
that order.
"""

from __future__ import annotations

import torch

from ..core.vecmath import constant

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
    park_d = constant(PARK_DIRECTION, torch.float32, d.device)
    return (
        torch.where(keep, o, torch.full_like(o, PARK_ORIGIN)),
        torch.where(keep, d, park_d.expand(d.shape)),
    )


def _part_bits10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` two zero bits apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(q: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` int32 in [0, 1024) -> 30-bit Morton code."""
    return (_part_bits10(q[..., 0]) | (_part_bits10(q[..., 1]) << 1)
            | (_part_bits10(q[..., 2]) << 2))


def ray_sort_keys(origin: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """int32 coherence key per ray of ``[N, 3]`` origins and directions:
    origin Morton code quantised over the batch's own bounds (top 15
    bits), direction octant (3 bits), the Morton code's low 15 bits."""
    lo = origin.amin(dim=0)
    hi = origin.amax(dim=0)
    # a tensor numerator: PyTorch computes ``scalar / x`` as the scalar
    # times 1 / x, which rounds twice
    scale = torch.full_like(lo, 1023.0) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((origin - lo) * scale, 0.0, 1023.0).to(torch.int32)
    m = morton30(q)
    octant = ((directions[..., 0] < 0).to(torch.int32)
              + 2 * (directions[..., 1] < 0).to(torch.int32)
              + 4 * (directions[..., 2] < 0).to(torch.int32))
    return ((m >> 15) << 18) | (octant << 15) | (m & 0x7FFF)


def cast_rays_sorted(cast_fn, scene, origin, directions, **kw):
    """``cast_fn`` over the rays in coherence-key order, hits returned in
    the rays' own order: the same result as the unsorted cast."""
    from .renderer import Hit

    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape)
    shape = directions.shape[:-1]
    flat_o = origin.reshape(-1, 3)
    flat_d = directions.reshape(-1, 3)
    order = torch.argsort(ray_sort_keys(flat_o, flat_d), stable=True)
    hit = cast_fn(scene, flat_o[order], flat_d[order], **kw)

    def unscatter(a):
        if a is None:  # a field the cast did not carry
            return None
        out = torch.empty_like(a)
        out[order] = a
        return out.reshape(shape + a.shape[1:])

    return Hit(*(unscatter(a) for a in hit))


def secondary_cast_fn(cast, backend: str, sort_secondary: bool = False):
    """The cast for secondary (shadow and bounce) rays: on the ``cuda``
    backend with ``sort_secondary``, ``cast`` in coherence-sorted order
    (``cast_rays_sorted``); otherwise ``cast`` itself."""
    if sort_secondary and backend == "cuda":
        return lambda scene, o, d, **kw: cast_rays_sorted(cast, scene, o, d, **kw)
    return cast
