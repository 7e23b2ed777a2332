"""The plain reference: the cells' frames worked out again in plain
PyTorch from the configuration's scene description (``scenes.py``) and
the run's camera inputs, importing nothing of the port (nor JAX).

It follows the semantics the port documents, written down here from the
description and not from the port's code paths:

  * camera: pixel (x, y, 1) through K^-1, the equidistant (Kannala-Brandt)
    radial map with the distortion D, normalised, axes swapped to
    y-forward / z-up, rotated by the inverse pose, normalised again; the
    origin is the pose's position;
  * instances: each instance's mesh baked to world space, ``apply_lre(
    invert_lre(pose), v * scale)`` (the order the port documents for
    ``Scene.flattened``), with the harness's own pose maths (``pose.py``);
    an identity instance's triangles pass through untouched. World
    triangles are numbered instance by instance, each mesh's in its order;
  * triangles are one-sided: a ray hits where d.n <= -1e-6 (n the
    normalised winding cross product), at t = ((v0 - o).n) / (d.n) >= 0,
    with the plane point's barycentrics u, v (affine rows of the
    triangle) inside up to EDGE_EPS = 1e-3; the nearest such t wins, and
    of equal t the lowest triangle index (the port's brute-force oracle's
    rule; its kernels may take another triangle of the same t);
  * shading: the sky colour (255, 204, 153) on a miss; flat, Lambert or
    Blinn-Phong (cosine plus 0.5 of the half-vector lobe to the 32nd)
    toward the directional light (-0.2, 0, 1), clamped to [0.4, 1],
    times the albedo times 255, truncated to u8;
  * path tracing: ``samples`` paths a pixel from one primary hit, each
    bounce a cosine-weighted sample (threefry2x32 streams, ``prng.py``)
    from 1e-4 off the hit point, the flat sky as the only light, the
    last bounce a visibility test toward the sky; the mean of the
    samples times 255, clamped and truncated to u8;
  * ambient occlusion: ``samples`` cosine-weighted rays from each
    primary hit, a sample occluded where its nearest hit lies nearer
    than ``radius``; the open share times 255, truncated, grey.

The casts walk a tree of the reference's own: the triangles sorted by
the Morton code of their centroids, cut into a complete binary tree of
leaves of at most ``LEAF`` triangles, each leaf's box that of its
triangles grown by EDGE_EPS (so that it holds every point the triangle
test accepts, and the walk answers as testing every triangle would:
``tests/test_rtbench_reference.py`` holds it to that). Rays walk it as a
wavefront, one node per live ray a step.

``precision="bfloat16"`` is the control: the same reference with its
geometry (the triangle records, each cast's ray origins and directions)
held in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng

FLT_MAX = 3.4028234663852886e38
PARALLEL_EPS = 1e-6
EDGE_EPS = 1e-3
NUDGE = 1e-12
SHADOW_EPS = 1e-4
SKY_COLOR = (255, 204, 153)
LIGHT_DIRECTION = (-0.2, 0.0, 1.0)
BLINN_SPECULAR = 0.5
BLINN_SHININESS = 32.0
LEAF = 4
TAIL = 4096  # rays still walking when the rest test every triangle
PRECISIONS = ("float32", "bfloat16")


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v * torch.rsqrt(dot(v, v))[..., None]


def _const(values, device):
    return torch.tensor(values, dtype=torch.float32).to(device)


def _morton(q):
    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return part(q[:, 0]) | (part(q[:, 1]) << 1) | (part(q[:, 2]) << 2)


IDS = ("instance", "mesh", "material", "local")


def bake(desc: dict) -> dict:
    """A scene description's world triangles ``v0``, ``v1``, ``v2`` and,
    for each, its ``instance``, ``mesh``, ``material`` and ``local`` (its
    index in its mesh): numpy arrays, world triangles in instance order."""
    from .pose import apply_lre, invert_lre

    parts = {k: [] for k in ("v0", "v1", "v2") + IDS}
    for i, (m, material, p, scale) in enumerate(desc["instances"]):
        mesh = desc["meshes"][m]
        p = torch.from_numpy(np.asarray(p, np.float32).reshape(6))
        scale = torch.from_numpy(np.asarray(scale, np.float32).reshape(3))
        moved = bool(p.any() or (scale != 1.0).any())
        inv_pose = invert_lre(p)
        for k in ("v0", "v1", "v2"):
            v = np.asarray(mesh[k], np.float32).reshape(-1, 3)
            parts[k].append(apply_lre(inv_pose, torch.from_numpy(v) * scale).numpy() if moved
                            else v)
        n = len(parts["v0"][-1])
        for k, value in (("instance", i), ("mesh", m), ("material", material)):
            parts[k].append(np.full(n, value, np.int64))
        parts["local"].append(np.arange(n, dtype=np.int64))
    return {k: np.concatenate(v) for k, v in parts.items()}


class Geometry:
    """The triangles on ``device``: records (v0, n, rA, rB), the
    reference's tree and, for each triangle, ``instance``, ``mesh``,
    ``material`` and ``local`` (its index in its mesh; int64 tensors)."""

    @classmethod
    def from_scene(cls, desc: dict, device, precision: str = "float32") -> "Geometry":
        """A scene description's geometry, its instances baked (``bake``)."""
        b = bake(desc)
        return cls(b["v0"], b["v1"], b["v2"], device, precision, {k: b[k] for k in IDS})

    def __init__(self, v0, v1, v2, device, precision: str = "float32", ids: dict | None = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision is one of {PRECISIONS}, got {precision!r}")
        self.device = torch.device(device)
        self.low = precision == "bfloat16"
        v0, v1, v2 = (np.asarray(v, np.float32).reshape(-1, 3) for v in (v0, v1, v2))
        T = len(v0)
        if ids is None:  # one mesh under one instance and material
            ids = {"instance": np.zeros(T, np.int64), "mesh": np.zeros(T, np.int64),
                   "material": np.zeros(T, np.int64), "local": np.arange(T, dtype=np.int64)}
        for k in IDS:
            setattr(self, k, torch.from_numpy(np.asarray(ids[k], np.int64)).to(self.device))
        n = np.cross(v1 - v0, v2 - v0)
        n = (n * (1.0 / np.sqrt(np.sum(n * n, axis=-1, keepdims=True)))).astype(np.float32)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        v0, v1, v2, n = t(v0), t(v1), t(v2), t(n)
        e0, e1 = v2 - v0, v1 - v0
        d00, d01, d11 = dot(e0, e0), dot(e0, e1), dot(e1, e1)
        inv = 1.0 / (d00 * d11 - d01 * d01)
        ra = (d11[:, None] * e0 - d01[:, None] * e1) * inv[:, None]
        rb = (d00[:, None] * e1 - d01[:, None] * e0) * inv[:, None]
        self.normal = n
        self.rec = self.q(torch.cat([v0, n, ra, rb], dim=1))
        self._build(v0, e0, e1)

    def q(self, x):
        """``x`` as the geometry holds it: bfloat16 in the control."""
        return x.to(torch.bfloat16).to(torch.float32) if self.low else x

    def _build(self, v0, e0, e1):
        T = v0.shape[0]
        dev = self.device
        c = v0 + (e0 + e1) / 3.0
        lo, hi = c.amin(0), c.amax(0)
        qc = ((c - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).clamp(0, 1023).to(torch.int64)
        order = torch.sort(_morton(qc), stable=True).indices
        nleaf = 1 << max(0, math.ceil(math.log2(max(1, math.ceil(T / LEAF)))))
        self.depth = int(math.log2(nleaf))
        per = math.ceil(T / nleaf)
        j = torch.arange(nleaf, device=dev)
        start, end = j * T // nleaf, (j + 1) * T // nleaf
        k = torch.arange(per, device=dev)
        slot = start[:, None] + k[None, :]
        valid = slot < end[:, None]
        self.leaf_tri = torch.where(valid, order[torch.clamp(slot, max=T - 1)],
                                    torch.full_like(slot, -1))
        # every point the test accepts: the triangle grown to barycentrics
        # in [-EDGE_EPS, 1 + 2 EDGE_EPS], its box padded for the test's rounding
        eps = EDGE_EPS
        corners = torch.stack([v0 - eps * (e0 + e1), v0 + (1 + 2 * eps) * e0 - eps * e1,
                               v0 - eps * e0 + (1 + 2 * eps) * e1], dim=1)
        tmin, tmax = corners.amin(1), corners.amax(1)
        pad = 1e-4 + 1e-5 * torch.maximum(tmin.abs(), tmax.abs())
        tmin, tmax = tmin - pad, tmax + pad
        idx = torch.clamp(self.leaf_tri, min=0)
        inf = torch.full((1, 1, 3), float("inf"), device=dev)
        lmin = torch.where(valid[..., None], tmin[idx], inf).amin(1)
        lmax = torch.where(valid[..., None], tmax[idx], -inf).amax(1)
        lvalid = valid.any(1)
        mins, maxs, oks = [lmin], [lmax], [lvalid]
        while mins[0].shape[0] > 1:
            m, x, ok = mins[0], maxs[0], oks[0]
            mins.insert(0, torch.minimum(m[0::2], m[1::2]))
            maxs.insert(0, torch.maximum(x[0::2], x[1::2]))
            oks.insert(0, ok[0::2] | ok[1::2])
        # heap layout: node i's children are 2i + 1 and 2i + 2, leaves last
        self.bmin, self.bmax, self.valid = torch.cat(mins), torch.cat(maxs), torch.cat(oks)
        self.first_leaf = nleaf - 1
        self.leaf_rec = self.rec[idx]
        self.leaf_ok = valid


def _inv_dir(d):
    tiny = torch.full_like(d, 1e-30)
    return 1.0 / torch.where(d.abs() < 1e-30, torch.where(d < 0, -tiny, tiny), d)


def _entry(o, inv, bmin, bmax):
    t0 = (bmin - o - NUDGE) * inv
    t1 = (bmax - o + NUDGE) * inv
    near = torch.fmin(t0, t1).amax(-1)
    far = torch.fmax(t0, t1).amin(-1)
    return torch.where((far >= near) & (far > 0.0), near, torch.full_like(near, FLT_MAX))


def _test(rec, o, d):
    """t and acceptance of rays ``o``, ``d`` [n, 1, 3] against records
    ``rec`` [n, L, 12]."""
    denom = d[..., 0] * rec[..., 3] + d[..., 1] * rec[..., 4] + d[..., 2] * rec[..., 5]
    c = rec[..., 0:3] - o
    num = c[..., 0] * rec[..., 3] + c[..., 1] * rec[..., 4] + c[..., 2] * rec[..., 5]
    t = num / denom
    e = t[..., None] * d - c
    u = dot(rec[..., 6:9], e)
    v = dot(rec[..., 9:12], e)
    ok = ((denom <= -PARALLEL_EPS) & (u >= -EDGE_EPS) & (v >= -EDGE_EPS)
          & (u + v <= 1.0 + EDGE_EPS) & (t >= 0.0))
    return t, ok


def _every_triangle(geom, o, d, t_best, tri, idx):
    """Rays ``idx`` tested against every triangle, ``t_best`` and ``tri``
    updated in place: the walk's last few rays, whose long walks would
    each cost a step of the whole wavefront."""
    T = geom.rec.shape[0]
    chunk = max(1, (1 << 26) // max(1, idx.numel()))
    oi, di = o[idx, None], d[idx, None]
    for lo in range(0, T, chunk):
        t, ok = _test(geom.rec[None, lo:lo + chunk], oi, di)
        t = torch.where(ok, t, torch.full_like(t, FLT_MAX))
        tmin, j = t.min(1)  # the first of equal minima: the lowest index
        j = j + lo
        better = (tmin < t_best[idx]) | ((tmin == t_best[idx]) & (j < tri[idx]))
        bi = idx[better]
        t_best[bi] = tmin[better]
        tri[bi] = j[better]


def cast(geom: Geometry, o, d, t_max: float = FLT_MAX, any_hit: bool = False,
         tail: int | None = None):
    """Nearest hit of rays ``o``, ``d`` [N, 3] with t < ``t_max``: (t [N],
    FLT_MAX on a miss; tri [N], -1 on a miss). ``any_hit``: a ray stops at
    its first accepted triangle (t is then that hit's, not the nearest).
    Once ``tail`` rays (default ``TAIL``) or fewer are still walking, they
    test every triangle instead."""
    tail = TAIL if tail is None else tail
    o, d = geom.q(o.reshape(-1, 3).contiguous()), geom.q(d.reshape(-1, 3).contiguous())
    N, dev = d.shape[0], d.device
    inv = _inv_dir(d)
    t_best = torch.full((N,), t_max, dtype=torch.float32, device=dev)
    tri = torch.full((N,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((N, geom.depth + 2), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((N, geom.depth + 2), dtype=torch.float32, device=dev)
    e = _entry(o, inv, geom.bmin[0], geom.bmax[0])
    sp = ((e < t_best) & geom.valid[0]).to(torch.int64)
    stack_t[:, 0] = e
    active = torch.nonzero(sp).squeeze(1)
    while active.numel():
        if active.numel() <= tail:
            _every_triangle(geom, o, d, t_best, tri, active)
            break
        s = sp[active] - 1
        node = stack[active, s]
        keep = stack_t[active, s] < t_best[active]
        sp[active] = s
        leaf = node >= geom.first_leaf
        m = keep & leaf
        if m.any():
            li, ln = active[m], node[m] - geom.first_leaf
            t, ok = _test(geom.leaf_rec[ln], o[li, None], d[li, None])
            ok = ok & geom.leaf_ok[ln] & (t <= t_best[li, None])
            t = torch.where(ok, t, torch.full_like(t, FLT_MAX))
            tmin = t.amin(1)
            # of equal t, the lowest triangle index, as testing every triangle in order
            tid = torch.where(ok & (t == tmin[:, None]), geom.leaf_tri[ln],
                              torch.full_like(geom.leaf_tri[ln], 1 << 62)).amin(1)
            tb, trb = t_best[li], tri[li]
            better = (tmin < tb) | ((tmin == tb) & (tid < trb) & (tid < 1 << 62))
            bi = li[better]
            t_best[bi] = tmin[better]
            tri[bi] = tid[better]
            if any_hit:
                sp[bi] = 0
        m = keep & ~leaf
        if m.any():
            ii, nd = active[m], node[m]
            oi, vi, tb = o[ii], inv[ii], t_best[ii]
            c0, c1 = 2 * nd + 1, 2 * nd + 2
            e0 = _entry(oi, vi, geom.bmin[c0], geom.bmax[c0])
            e1 = _entry(oi, vi, geom.bmin[c1], geom.bmax[c1])
            h0 = geom.valid[c0] & (e0 < tb)
            h1 = geom.valid[c1] & (e1 < tb)
            # the far child first, so the near one is popped next
            swap = e1 > e0
            far, far_e, far_h = (torch.where(swap, c1, c0), torch.where(swap, e1, e0),
                                 torch.where(swap, h1, h0))
            near, near_e, near_h = (torch.where(swap, c0, c1), torch.where(swap, e0, e1),
                                    torch.where(swap, h0, h1))
            s = sp[ii]
            for child, ce, ch in ((far, far_e, far_h), (near, near_e, near_h)):
                pi = ii[ch]
                stack[pi, s[ch]] = child[ch]
                stack_t[pi, s[ch]] = ce[ch]
                s = s + ch.to(torch.int64)
            sp[ii] = s
        active = active[sp[active] > 0]
    return torch.where(tri >= 0, t_best, torch.full_like(t_best, FLT_MAX)), tri


def raygen(width, height, K_inv, D, pose, inv_pose, device):
    """(origin [3], directions [H, W, 3]) of the camera."""
    K_inv, D, pose, inv_pose = (x.to(device) for x in (K_inv, D, pose, inv_pose))
    from .pose import apply_euler

    x = torch.arange(width, dtype=torch.float32, device=device).expand(height, width)
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    ph = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    direction = dot(K_inv, ph[..., None, :])
    a, b = direction[..., 0], direction[..., 1]
    radius = torch.sqrt(a * a + b * b)
    theta = torch.atan(radius)
    thetad = theta * (1.0 + D[0] * theta + D[1] * theta ** 2 + D[2] * theta ** 3
                      + D[3] * theta ** 4)
    pos = radius > 0.0
    scale = torch.where(pos, thetad / torch.where(pos, radius, torch.ones_like(radius)),
                        torch.ones_like(radius))
    direction = normalize(torch.stack([scale * a, scale * b, direction[..., 2]], dim=-1))
    direction = torch.stack([direction[..., 0], direction[..., 2], -direction[..., 1]], dim=-1)
    direction = normalize(apply_euler(inv_pose[3:6], direction))
    return pose[0:3], direction


class Hits:
    """A cast's shading inputs: hit mask, point, unit normal, and ``tri``,
    the world triangle hit (-1 on a miss)."""

    def __init__(self, geom, o, d, any_hit=False, t_max=FLT_MAX, live=None):
        shape = d.shape[:-1]
        o = o.expand(d.shape).reshape(-1, 3)
        d = d.reshape(-1, 3)
        t = torch.full((d.shape[0],), FLT_MAX, dtype=torch.float32, device=d.device)
        tri = torch.full((d.shape[0],), -1, dtype=torch.int64, device=d.device)
        idx = None if live is None else torch.nonzero(live.reshape(-1)).squeeze(1)
        if idx is None:
            t, tri = cast(geom, o, d, t_max, any_hit)
        elif idx.numel():
            t[idx], tri[idx] = cast(geom, o[idx], d[idx], t_max, any_hit)
        hit = tri >= 0
        tp = torch.where(hit, t, torch.zeros_like(t))
        self.hit = hit.reshape(shape)
        self.tri = tri.reshape(shape)
        self.t = t.reshape(shape)
        self.location = (o + tp[:, None] * d).reshape(shape + (3,))
        self.normal = normalize(geom.normal[torch.clamp(tri, min=0)]).reshape(shape + (3,))


def _sky(device):
    return _const(SKY_COLOR, device) / 255.0


def to_u8(x):
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def primary(geom, rays, albedo, lighting: str = "blinn_phong"):
    """The primary frame -> u8 [H, W, 3]."""
    o, d = rays
    return shade(Hits(geom, o, d), d, albedo, lighting)


def shade(h, d, albedo, lighting: str = "blinn_phong"):
    """Primary hits ``h`` of rays ``d`` shaded -> u8 [H, W, 3]; ``albedo``
    an RGB triple, or a tensor [H, W, 3] of each hit's surface colour."""
    dev = d.device
    if lighting == "flat":
        illum = torch.ones(h.t.shape, dtype=torch.float32, device=dev)
    else:
        light = normalize(_const(LIGHT_DIRECTION, dev))
        illum = torch.clamp(dot(h.normal, light), min=0.0)
        if lighting == "blinn_phong":
            half = normalize(light + (-normalize(d)))
            spec = torch.clamp(dot(h.normal, half), min=0.0)
            illum = illum + BLINN_SPECULAR * spec ** BLINN_SHININESS
        elif lighting != "lambert":
            raise ValueError(f"the reference shades flat, lambert or blinn_phong, not {lighting!r}")
    illum = torch.clamp(torch.clamp(illum, max=1.0), min=0.4)
    color = albedo if isinstance(albedo, torch.Tensor) else _const(albedo, dev)
    shaded = (illum[..., None] * color * 255.0).to(torch.uint8)
    sky = torch.tensor(SKY_COLOR, dtype=torch.uint8, device=dev)
    return torch.where(h.hit[..., None], shaded, sky)


def cosine_sample(key, normal):
    """A cosine-weighted direction about each ``normal`` [..., 3]."""
    shape = normal.shape[:-1]
    u = prng.uniform(key.to(normal.device), shape + (2,))
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    n = normal
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], -1)
    bv = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return normalize(x[..., None] * t + y[..., None] * bv + z[..., None] * n)


def path_traced(geom, rays, key, albedo, samples: int, max_bounces: int):
    """The path-traced frame of a Lambertian scene under the flat sky ->
    u8 [H, W, 3]."""
    o, d = rays
    dev = d.device
    bshape = (samples,) + d.shape[:-1]
    bc = lambda x: x[None].expand((samples,) + x.shape)
    sky = _sky(dev)
    color = _const(albedo, dev)
    h = Hits(geom, o, d)
    hit, loc, normal = bc(h.hit), bc(h.location), bc(h.normal)
    o, d = bc(o.expand(d.shape)), bc(d)
    T = torch.ones(bshape + (3,), dtype=torch.float32, device=dev)
    R = torch.zeros(bshape + (3,), dtype=torch.float32, device=dev)
    active = torch.ones(bshape, dtype=torch.bool, device=dev)
    keys = prng.split(key.to(dev), max_bounces + 1)
    for b in range(max_bounces + 1):
        if b > 0 and b == max_bounces:
            # the last bounce: whether the sky is seen is the whole answer
            seen = ~Hits(geom, o, d, any_hit=True, live=active).hit
            R = R + torch.where((active & seen)[..., None], T * sky, 0.0)
            break
        if b > 0:
            h = Hits(geom, o, d, live=active)
            hit, loc, normal = h.hit, h.location, h.normal
        R = R + torch.where((active & ~hit)[..., None], T * sky, 0.0)
        live = active & hit
        T = T * torch.where(live[..., None], color, 1.0)
        d_new = cosine_sample(keys[b], normal)
        o = torch.where(live[..., None], loc + d_new * SHADOW_EPS, o)
        d = torch.where(live[..., None], d_new, d)
        active = live
    return to_u8(R.mean(dim=0))


def ambient_occlusion(geom, rays, key, samples: int, radius: float):
    """The AO frame -> grey u8 [H, W, 3]."""
    o, d = rays
    h = Hits(geom, o, d)
    total = torch.zeros(h.t.shape, dtype=torch.float32, device=d.device)
    for k in prng.split(key.to(d.device), samples):
        ds = cosine_sample(k, h.normal)
        occ = Hits(geom, h.location + ds * SHADOW_EPS, ds, t_max=radius, live=h.hit).hit
        total = total + torch.where(h.hit, 1.0 - occ.to(torch.float32), 1.0)
    ao = total / samples
    return to_u8(ao[..., None].expand(ao.shape + (3,)))
