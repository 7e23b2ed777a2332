"""The plain Whitted reference: the frame of ``compiled_render_image_whitted``
worked out again in plain PyTorch, float32, from the scene description
and the run's rays, on ``reference.py``'s casts. It imports nothing of the
port (nor JAX) and is written from the port's documented equations
(``render/integrators.py render_whitted``, ``render/shade.py``), not from
its code paths.

Each bounce, for the rays still live (all of them at the first):

  * nearest hit: ``reference.Hits`` (the baked world triangles; the hit's
    triangle ``tri``, its instance's material, mesh and index in its mesh);
  * surface colour: the material's albedo, or, where it is textured, the
    texel at the hit's uv (the triangle's corner uvs interpolated at the
    hit's barycentrics), nearest filter: column ``trunc(u W) mod W``, row
    ``trunc((1 - v) H) mod H`` (C's truncating modulo, then at least 0),
    times ``TEXEL_SCALE``;
  * directional light: ``cos = max(n . l, 0)`` with ``l`` the unit vector
    toward ``LIGHT_DIRECTION``; where a hit's ``cos > 0.4`` an any-hit
    shadow ray from ``location + l SHADOW_EPS`` toward ``l``, and where it
    is occluded the light keeps ``0.4 cos``; the illumination is clamped
    to [0.4, 1] (so a shadow ray at ``cos <= 0.4`` could not show);
  * radiance: ``local = colour illum (1 - reflectivity) + illumination``
    (the material's emission) times the throughput where hit; the flat sky
    times the throughput where a live ray misses;
  * next bounce: ``throughput *= colour reflectivity``, the direction the
    mirror ``normalize(d - 2 (d . n) n)``, the origin ``location + d'
    SHADOW_EPS``, live only where hit and ``reflectivity > 0``.

The frame is the radiance times 255, clamped to [0, 255] and truncated to
u8 (``tonemap`` "none" at exposure 1).

Departures from the port, each noted: the normal is the baked world
triangle's normalised winding cross product, where the port rotates the
mesh's face normal and multiplies it by the instance's scale
(``normal_mode`` "reference": the same direction under this scene's
uniform and yaw-only scales, up to rounding); the hit point is ``o + t d``
in world space, where the port maps the object-space point back; of
equal t the lowest world triangle index wins. A ray that is not live is
not cast, where the port casts it parked (the same answer: a miss).
The reference runs no matrix multiplication, so TF32 cannot enter.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as plain

TEXEL_SCALE = 0.0039215  # the port's texel scale, its reference's literal 1/255
SHADOW_FLOOR = 0.4  # the light an occluded hit keeps, times its cosine
CLAMP = (0.4, 1.0)  # the illumination's clamp


def _corner_uvs(ref, dev):
    """Each world triangle's corner uvs ``[T, 2]`` x 3 (zeros for a mesh
    without uvs)."""
    meshes = ref.scene["meshes"]
    start = torch.tensor(np.cumsum([0] + [len(m["v0"]) for m in meshes[:-1]]), device=dev)
    row = start[ref.geom.mesh] + ref.geom.local
    return [torch.from_numpy(np.concatenate([np.asarray(m.get(c, np.zeros((len(m["v0"]), 2))),
                                                        np.float32).reshape(-1, 2)
                                             for m in meshes])).to(dev)[row]
            for c in ("uv0", "uv1", "uv2")]


def _texel(tex, uv, dev):
    th, tw = tex.shape[:2]
    x = torch.clamp(torch.fmod((uv[..., 0] * tw).to(torch.int32), tw), min=0)
    y = torch.clamp(torch.fmod(((1.0 - uv[..., 1]) * th).to(torch.int32), th), min=0)
    texels = torch.from_numpy(np.ascontiguousarray(tex)).to(dev).to(torch.float32)
    return texels[y.long(), x.long()] * TEXEL_SCALE


def surface_color(ref, h, corners):
    """Each hit's albedo or texel (nearest) ``[..., 3]``."""
    dev = h.location.device
    tri = torch.clamp(h.tri, min=0)
    rec = ref.geom.rec[tri]
    e = h.location - rec[..., 0:3]
    u, v = plain.dot(rec[..., 6:9], e), plain.dot(rec[..., 9:12], e)
    uv0, uv1, uv2 = (c[tri] for c in corners)
    uv = (1.0 - u - v)[..., None] * uv0 + v[..., None] * uv1 + u[..., None] * uv2
    mat = ref.geom.material[tri]
    color = torch.zeros(mat.shape + (3,), dtype=torch.float32, device=dev)
    for k, m in enumerate(ref.scene["materials"]):
        tex = m.get("texture")
        value = (torch.tensor(m.get("albedo", (1.0, 1.0, 1.0)), dtype=torch.float32, device=dev)
                 if tex is None else _texel(tex, uv, dev))
        color = torch.where((mat == k)[..., None], value, color)
    return color


def _table(ref, key, dev):
    return torch.tensor([float(m.get(key, 0.0)) for m in ref.scene["materials"]],
                        dtype=torch.float32, device=dev)


def whitted(ref, rays, max_bounces: int = 2, shadows: bool = True):
    """The Whitted frame of rays ``(origin [3], directions [H, W, 3])`` ->
    u8 [H, W, 3] (``ref``: ``geom``, ``scene``, as ``check.Reference``)."""
    o, d = rays
    dev = d.device
    o = o.to(dev).expand(d.shape)
    shape = d.shape[:-1]
    geom = ref.geom
    corners = _corner_uvs(ref, dev)
    reflectivity, emission = _table(ref, "reflectivity", dev), _table(ref, "illumination", dev)
    light = plain.normalize(torch.tensor(plain.LIGHT_DIRECTION, dtype=torch.float32, device=dev))
    sky = torch.tensor(plain.SKY_COLOR, dtype=torch.float32, device=dev) / 255.0
    radiance = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones(shape + (3,), dtype=torch.float32, device=dev)
    live = torch.ones(shape, dtype=torch.bool, device=dev)
    for bounce in range(max_bounces + 1):
        h = plain.Hits(geom, o, d, live=None if bounce == 0 else live)
        radiance = radiance + torch.where((live & ~h.hit)[..., None], throughput * sky, 0.0)
        hit = live & h.hit
        cos = torch.clamp(plain.dot(h.normal, light), min=0.0)
        if shadows:
            need = hit & (cos > SHADOW_FLOOR)
            occluded = plain.Hits(geom, h.location + light * plain.SHADOW_EPS,
                                  light.expand(d.shape), any_hit=True, live=need).hit
            cos = torch.where(occluded, SHADOW_FLOOR * cos, cos)
        illum = torch.clamp(cos, *CLAMP)
        color = surface_color(ref, h, corners)
        mat = geom.material[torch.clamp(h.tri, min=0)]
        refl, emit = reflectivity[mat], emission[mat]
        local = color * illum[..., None] * (1.0 - refl[..., None]) + emit[..., None]
        radiance = radiance + torch.where(hit[..., None], throughput * local, 0.0)
        if bounce == max_bounces:
            break
        throughput = throughput * torch.where(hit[..., None], color * refl[..., None], 0.0)
        live = hit & (refl > 0.0)
        mirror = plain.normalize(d - 2.0 * plain.dot(d, h.normal)[..., None] * h.normal)
        o = torch.where(live[..., None], h.location + mirror * plain.SHADOW_EPS, o)
        d = torch.where(live[..., None], mirror, d)
    return plain.to_u8(radiance)
