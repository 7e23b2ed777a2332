"""Multi-bounce integrators — Whitted reflections, path tracing and
ambient occlusion — and the display mapping of float radiance.

Counterpart of ``tpu_raytracer/render/integrators.py``. Each bounce is a
wavefront: the whole ray batch is cast through the backend's nearest-hit
cast, with terminated rays parked rather than compacted; the directional
light's hard shadows and the path tracer's final bounce use the any-hit
cast. Random numbers are the JAX package's threefry streams
(``utils/prng.py``): the same key draws the same numbers in both packages.
Colours are float [0, 1] until ``to_u8``.

The casts of the whole batch carry the face normal on the ``cuda``
backend (``get_cast_fn(backend, want_normals=True)``), as the JAX
package's do: the shading reads normals at every bounce.

Both integrators take ``_sharded_hooks``, the seam of the scene-sharded
renders (``parallel/scene_shard.py``): a dict of ``cast_attrs`` (o, d) ->
HitAttributes, ``occ`` and ``nearest`` (scene, o, d) -> Hit, the casts
combined over the ranks that each hold a chunk of the geometry. The
hooks take the place of exactly the cast and attribute sites, so the
sharded frame is this estimator's; without them nothing changes.

The integrators' work is cut into the frame's stages
(``utils/profiling.py``): ``cast`` (each cast with its rays' prep),
``attrs``, ``sample`` (``sample_cosine``: each draw's cosine samples and
the path tracer's lobe uniforms), ``bounce`` (``path_bounce``: the rest of
the path tracer's bounce arithmetic; AO's accumulation) and ``output`` (the
mean over samples); Whitted's bounce is ``cast``, ``attrs``, ``light``
(``_direct_illumination``: the shadow rays' set-up and the light term, its
any-hit cast in a ``cast`` of its own) and ``shade`` (``whitted_shade``:
the sky, the surface colour, the radiance and throughput sums, the
reflected rays and their parking).
``sample_cosine`` routes: CUDA tensors launch kernel S4 (``kernels/frame.py
sample_cosine_cuda``), one launch a draw, CPU tensors take the plain
version ``sample_cosine_torch``. A draw's key is the frame's key folded
with a static chain of words, ``split(key, n)[i]`` being ``fold_in(key,
i)``: AO's sample s draws with ``(s,)``, the batched path tracer's bounce b
with ``(b,)``, the sequential one's sample s with ``(s, b)``; the lens
draws of depth of field stay on ``utils/prng.py``. ``whitted_shade`` routes
the same way: kernel S5 (``kernels/frame.py whitted_shade_cuda``), one
launch a bounce, or the plain version ``whitted_shade_torch``; and
``path_bounce``: kernel S6 (``kernels/frame.py path_bounce_cuda``), one
launch a bounce and one for the fast tail, or the plain version
``path_bounce_torch``.

Not ported: the Whitted ray retiling and the TPU packet geometry of
bounce casts.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.vecmath import FLT_MAX, constant, dot, normalize
from ..kernels.frame import LOBE_WORD
from ..utils import prng
from ..utils.profiling import stage
from .renderer import get_cast_fn, hit_attributes, occlusion_cast_fn
from .shade import (
    DEFAULT_LIGHT_DIRECTION, SHADOW_EPS, light_vector, point_light_illumination, sky_radiance,
    surface_color,
)
from .sorted_cast import park_dead_rays, secondary_cast_fn


@dataclasses.dataclass(frozen=True)
class PointLight:
    """A point light: position and intensity (the reference's
    ``cast_toward_lights`` sketch)."""

    position: tuple
    intensity: float = 100.0


def _reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _direct_illumination(scene, cast, attrs, light_direction, point_lights, exact, shadows,
                         occ_cast=None, shadow_floor=0.4, clamp_floor=None):
    """Directional and point-light contribution at the hit points, with a
    hard shadow ray toward the directional light where ``shadows``: the
    occluded term keeps ``shadow_floor`` times the cosine. ``occ_cast``
    is the any-hit cast for that boolean query (default ``cast``); the
    point lights' shadows are distance-bounded and take the nearest-hit
    ``cast``. Rays whose answer cannot show park: where the cosine is 0,
    or, with a caller-side clamp at ``clamp_floor`` and no point lights,
    at or below that floor."""
    illum = torch.zeros(attrs.t.shape, dtype=torch.float32, device=attrs.t.device)
    if light_direction is not None:
        ldir = light_vector(light_direction, attrs.t.device, exact)
        cos_i = torch.clamp(dot(attrs.normal, ldir), min=0.0)
        if shadows:
            thresh = clamp_floor if clamp_floor is not None and not point_lights else 0.0
            need = attrs.hit & (cos_i > thresh)
            with stage("cast"):
                occ = (occ_cast or cast)(scene, *park_dead_rays(
                    attrs.location + ldir * SHADOW_EPS, ldir.expand(attrs.location.shape),
                    need))
            lit = occ.t >= FLT_MAX
            cos_i = torch.where(lit, cos_i, shadow_floor * cos_i)
        illum = illum + cos_i
    if point_lights:
        illum = illum + point_light_illumination(scene, attrs, point_lights,
                                                 cast=cast if shadows else None)
    return illum


def render_whitted(scene, origin, directions, max_bounces: int = 2, backend: str = "cuda",
                   light_direction=DEFAULT_LIGHT_DIRECTION, point_lights: tuple = (),
                   shadows: bool = True, exact: bool = True, sort_secondary: bool = False,
                   tex_filter: str = "nearest", normal_mode: str = "reference",
                   _sharded_hooks: dict | None = None) -> torch.Tensor:
    """Whitted-style mirror reflections, unrolled over bounces -> float
    radiance [..., 3] in [0, 1].

    Local shading is weighted (1 - reflectivity); a mirror bounce
    continues with weight reflectivity. Illumination is clamped to
    [0.4, 1] as in the primary pass, so shadow rays with a cosine at or
    below 0.4 park (without point lights). Point lights' shadows take the
    nearest-hit cast of the batch (``PointLight``). Each bounce's shade is
    ``whitted_shade``: kernel S5 on the card."""
    cast = get_cast_fn(backend, want_normals=True)
    cast2 = secondary_cast_fn(cast, backend, sort_secondary)
    occ_cast = occlusion_cast_fn(backend)
    dcast = cast2
    if _sharded_hooks is not None:
        dcast, occ_cast = _sharded_hooks["nearest"], _sharded_hooks["occ"]
    directions = torch.as_tensor(directions, dtype=torch.float32)
    with stage("cast"):  # the first cast's rays
        origin = torch.as_tensor(origin, dtype=torch.float32).expand(directions.shape).contiguous()
    o, d, state = origin, directions, None
    for bounce in range(max_bounces + 1):
        if _sharded_hooks is not None:
            attrs = _sharded_hooks["cast_attrs"](o, d)
        else:
            with stage("cast"):
                hit = (cast if bounce == 0 else cast2)(scene, o, d)
            with stage("attrs"):
                attrs = hit_attributes(scene, o, d, hit, exact=exact, normal_mode=normal_mode)

        with stage("light"):  # its shadow rays' any-hit cast is stage cast
            illum = _direct_illumination(scene, dcast, attrs, light_direction, point_lights,
                                         exact, shadows, occ_cast=occ_cast, clamp_floor=0.4)
        last = bounce == max_bounces
        state, rays = whitted_shade(scene, d, attrs, illum, state, exact, tex_filter, last)
        if not last:
            o, d = rays
    return state[0]


def whitted_shade(scene, directions, attrs, illum, state=None, exact: bool = True,
                  tex_filter: str = "nearest", last: bool = False):
    """One Whitted bounce's ``shade`` stage after its light term ``illum``
    [...]: the radiance of the rays ``directions`` [..., 3] that missed and
    of those that hit (``attrs``), and, unless ``last``, the reflected rays
    of the next bounce, parked where the ray died or its surface is no
    mirror. ``state`` is (radiance [..., 3], throughput [..., 3], active
    [...]), None at the first bounce: (state, (origins, directions) or
    None). CUDA tensors launch kernel S5 (``kernels/frame.py
    whitted_shade_cuda``), which updates the state in place; CPU tensors
    take the plain version ``whitted_shade_torch``."""
    if directions.device.type == "cpu":
        return whitted_shade_torch(scene, directions, attrs, illum, state, exact, tex_filter,
                                   last)
    from ..kernels.frame import whitted_shade_cuda

    with stage("shade"):
        return whitted_shade_cuda(scene, directions, attrs, illum, state, exact, tex_filter,
                                  last)


def whitted_shade_torch(scene, directions, attrs, illum, state=None, exact: bool = True,
                        tex_filter: str = "nearest", last: bool = False):
    """The plain version of ``whitted_shade`` (and of kernel S5): the
    eager shade body of ``render_whitted``."""
    with stage("shade"):
        d = directions
        if state is None:
            shape, dev = d.shape[:-1], d.device
            state = (torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
                     torch.ones(shape + (3,), dtype=torch.float32, device=dev),
                     torch.ones(shape, dtype=torch.bool, device=dev))
        radiance, throughput, active = state
        miss = active & ~attrs.hit
        sky = sky_radiance(scene, d, exact=exact)
        radiance = radiance + torch.where(miss[..., None], throughput * sky, 0.0)

        live = active & attrs.hit
        color = surface_color(scene, attrs, tex_filter)
        illum = torch.clamp(illum, 0.4, 1.0)
        refl = scene.mat_reflectivity[attrs.material]
        emit = scene.mat_illumination[attrs.material]
        local = color * illum[..., None] * (1.0 - refl[..., None]) + emit[..., None]
        radiance = radiance + torch.where(live[..., None], throughput * local, 0.0)

        if last:
            return (radiance, throughput, active), None
        throughput = throughput * torch.where(live[..., None], color * refl[..., None], 0.0)
        active = live & (refl > 0.0)
        d = normalize(_reflect(d, attrs.normal), exact=exact)
        o = attrs.location + d * SHADOW_EPS
        return (radiance, throughput, active), park_dead_rays(o, d, active)


def sample_cosine(key, chain, normal, exact: bool = True, lobe: bool = False):
    """Cosine-weighted hemisphere samples around ``normal [..., 3]`` drawn
    with ``key`` folded with each word of ``chain`` in turn; with ``lobe``
    also the path tracer's lobe uniforms ``[...]``, drawn with that key
    folded with ``kernels/frame.py LOBE_WORD``: (directions, uniforms).
    CUDA tensors launch kernel S4
    (``kernels/frame.py sample_cosine_cuda``), CPU tensors take the plain
    version ``sample_cosine_torch``."""
    if normal.device.type == "cpu":
        return sample_cosine_torch(key, chain, normal, exact, lobe)
    from ..kernels.frame import sample_cosine_cuda

    with stage("sample"):
        return sample_cosine_cuda(key, chain, normal, exact, lobe)


def sample_cosine_torch(key, chain, normal, exact: bool = True, lobe: bool = False):
    """The plain version of ``sample_cosine`` (and of kernel S4): the key's
    ``prng.fold_in`` chain, ``prng.uniform`` and ``_cosine_sample``."""
    with stage("sample"):
        k = key.to(normal.device)
        for word in chain:
            k = prng.fold_in(k, word)
        d = _cosine_sample(k, normal, exact)
        if not lobe:
            return d
        return d, prng.uniform(prng.fold_in(k, LOBE_WORD), normal.shape[:-1])


def _cosine_sample(key, normal, exact):
    """Cosine-weighted hemisphere sample around ``normal [..., 3]``."""
    with stage("sample"):
        shape = normal.shape[:-1]
        u = prng.uniform(key.to(normal.device), shape + (2,))
        r = torch.sqrt(u[..., 0])
        phi = 2.0 * math.pi * u[..., 1]
        x = r * torch.cos(phi)
        y = r * torch.sin(phi)
        z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
        # orthonormal basis around n
        n = normal
        sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + n[..., 2])
        b = n[..., 0] * n[..., 1] * a
        t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], -1)
        bvec = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
        d = x[..., None] * t + y[..., None] * bvec + z[..., None] * n
        return normalize(d, exact=exact)


def path_bounce(scene, directions, attrs, state=None, key=None, chain: tuple = (), illum=None,
                exact: bool = True, tex_filter: str = "nearest", sky_strength: float = 1.0,
                light_scale: float = 0.0, tail: bool = False):
    """One path-tracing bounce's ``bounce`` stage on the rays ``directions``
    [..., 3] and their hit attributes ``attrs``: the sky (times
    ``sky_strength``) where an active ray missed; where it hit, the
    emission, the throughput times the surface colour and, where NEE's
    light term ``illum`` [...] is given, that term on the diffuse part of
    the lobe mix, weighted by ``light_scale``; then the next rays, drawn
    with ``key`` folded with ``chain`` (``sample_cosine``'s lobe draw):
    the glossy lobe with probability ``mat_reflectivity`` (the mirror
    blended toward the cosine sample by ``mat_roughness``), else the
    cosine sample, offset and parked where the ray died. ``state`` is
    (radiance [..., 3], throughput [..., 3], active [...]), None at the
    first bounce: (state, (origins, directions)). With ``tail`` (the fast
    tail) ``attrs`` is the any-hit cast's ``Hit`` and the sky is added
    where it missed: (state, None). CUDA tensors launch kernel S6
    (``kernels/frame.py path_bounce_cuda``; a bounce after its S4 draw),
    which updates the state in place; CPU tensors take the plain version
    ``path_bounce_torch``."""
    if directions.device.type == "cpu":
        return path_bounce_torch(scene, directions, attrs, state, key, chain, illum, exact,
                                 tex_filter, sky_strength, light_scale, tail)
    from ..kernels.frame import path_bounce_cuda

    samples = None if tail else sample_cosine(key, chain, attrs.normal, exact, lobe=True)
    return path_bounce_cuda(scene, directions, attrs, samples, illum, state, exact, tex_filter,
                            sky_strength, light_scale, tail)


def path_bounce_torch(scene, directions, attrs, state=None, key=None, chain: tuple = (),
                      illum=None, exact: bool = True, tex_filter: str = "nearest",
                      sky_strength: float = 1.0, light_scale: float = 0.0, tail: bool = False):
    """The plain version of ``path_bounce`` (and of kernel S6): the eager
    bounce body of ``render_path_traced``."""
    d = directions
    if state is None:
        shape, dev = d.shape[:-1], d.device
        state = (torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
                 torch.ones(shape + (3,), dtype=torch.float32, device=dev),
                 torch.ones(shape, dtype=torch.bool, device=dev))
    radiance, throughput, active = state
    sky = sky_radiance(scene, d, exact=exact) * sky_strength
    if tail:
        # final bounce: visibility of the sky is the whole answer
        miss = active & (attrs.t >= FLT_MAX)
        return (radiance + torch.where(miss[..., None], throughput * sky, 0.0), throughput,
                active), None
    miss = active & ~attrs.hit
    radiance = radiance + torch.where(miss[..., None], throughput * sky, 0.0)
    live = active & attrs.hit
    color = surface_color(scene, attrs, tex_filter)
    emit = scene.mat_illumination[attrs.material]
    refl = scene.mat_reflectivity[attrs.material]
    rough = scene.mat_roughness[attrs.material][..., None]
    radiance = radiance + torch.where(live[..., None], throughput * emit[..., None], 0.0)
    throughput = throughput * torch.where(live[..., None], color, 1.0)
    if illum is not None:
        # the light's term on the diffuse part of the lobe mix:
        # T * (1 - refl) * albedo / pi * cos_i * vis * intensity
        wgt = (1.0 - refl) * illum * light_scale
        radiance = radiance + torch.where(live[..., None], throughput * wgt[..., None], 0.0)
    d_diff, u = sample_cosine(key, chain, attrs.normal, exact, lobe=True)
    # glossy lobe: the mirror blended toward the cosine sample by
    # roughness, back to the cosine sample where it dips under the
    # surface
    mirror = _reflect(d, attrs.normal)
    d_spec = normalize((1.0 - rough) * mirror + rough * d_diff, exact=exact)
    d_spec = torch.where((dot(d_spec, attrs.normal) > 0.0)[..., None], d_spec, d_diff)
    d_new = torch.where((u < refl)[..., None], d_spec, d_diff)
    o_new = attrs.location + d_new * SHADOW_EPS
    return (radiance, throughput, live), park_dead_rays(o_new, d_new, live)


def lens_basis(directions: torch.Tensor, exact: bool = True):
    """(right, up): the thin lens's disk axes, perpendicular to the mean
    view axis of ``directions [..., 3]``. The reference vector is +z, or
    +x where the axis is within acos(0.9) of z, chosen on the device (the
    JAX package's ``jnp.where``), so the frame waits on no host read."""
    dev = directions.device
    axis = normalize(directions.reshape(-1, 3).mean(dim=0), exact=exact)
    ref = torch.where(torch.abs(axis[2]) < 0.9, constant((0.0, 0.0, 1.0), torch.float32, dev),
                      constant((1.0, 0.0, 0.0), torch.float32, dev))
    right = normalize(torch.linalg.cross(axis, ref), exact=exact)
    return right, torch.linalg.cross(right, axis)


def render_path_traced(scene, origin, directions, key, max_bounces: int = 3, samples: int = 4,
                       backend: str = "cuda", sky_strength: float = 1.0, exact: bool = True,
                       sort_secondary: bool = False, tex_filter: str = "nearest",
                       lens_radius: float = 0.0, focus_distance: float = 4.0,
                       light_direction=None, point_lights: tuple = (),
                       sun_intensity: float = 1.0, normal_mode: str = "reference",
                       sample_batch: bool = True, fast_tail: bool = True,
                       _sharded_hooks: dict | None = None) -> torch.Tensor:
    """Monte-Carlo path tracing -> float radiance ``[..., 3]``.

    Lambertian BRDF with cosine-weighted sampling, emissive materials
    through ``mat_illumination``, the sky as the ambient environment.
    With probability ``mat_reflectivity`` a sample continues in the
    glossy lobe (the mirror direction blended toward the cosine sample
    by ``mat_roughness``), else in the diffuse one. ``light_direction``
    turns on next-event estimation: at every bounce the diffuse lobe
    adds the directional light's term through an any-hit shadow cast.
    ``lens_radius > 0`` adds thin-lens depth of field, sampled per
    sample on a lens disk perpendicular to the mean view axis.

    ``sample_batch`` (the default, as in the JAX package)
    runs all samples as one ``(samples,) + shape`` wavefront after one
    primary cast; without it, or with a lens, samples run one after
    another. ``fast_tail`` (the JAX package's fast tail): with no emissive
    material and no NEE the last bounce's answer is hit or miss, so it
    is cast with the any-hit cast. The bounce casts and the tail's any-hit
    cast take the rays in wavefront order, ``(samples,) + shape``, as the
    bounce writes them. ``sort_secondary`` casts them in coherence order
    on the ``cuda`` backend instead (``sorted_cast``): the image does not
    change, and on an H100 the sort's keys, argsort, gathers and scatter
    cost ~3 ms of device time in a 1080p frame of 2 spp and 2 bounces,
    several times what K1 gains from walking the rays in that order.
    ``key`` is a ``utils.prng`` key; the random
    streams are the JAX package's. ``point_lights`` add to NEE: their
    shadows take the nearest-hit cast (distance-bounded)."""
    cast = get_cast_fn(backend, want_normals=True)
    cast2 = secondary_cast_fn(cast, backend, sort_secondary)
    occ_cast = occlusion_cast_fn(backend)
    nee = light_direction is not None or bool(point_lights)
    fast_tail = fast_tail and not nee and not scene.has_emissive and max_bounces >= 1
    tail_occ = secondary_cast_fn(occlusion_cast_fn(backend), backend, sort_secondary)
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32)
    shape = directions.shape[:-1]
    dev = directions.device
    key = key.to(dev)
    # NEE's weight: 1 / pi times the sun's intensity
    shading = dict(exact=exact, tex_filter=tex_filter, sky_strength=sky_strength,
                   light_scale=(1.0 / math.pi) * sun_intensity)

    def attrs_of(c, o, d):
        with stage("cast"):
            # kernel wrappers take contiguous rays only (broadcast views are rejected)
            o, d = o.contiguous(), d.contiguous()
            hit = c(scene, o, d)
        with stage("attrs"):
            return hit_attributes(scene, o, d, hit, exact=exact, normal_mode=normal_mode)

    nee_cast, nee_occ = cast, occ_cast
    attrs_primary = lambda o, d: attrs_of(cast, o, d)
    attrs_bounce = lambda o, d: attrs_of(cast2, o, d)
    if _sharded_hooks is not None:
        attrs_primary = attrs_bounce = _sharded_hooks["cast_attrs"]
        tail_occ = _sharded_hooks["occ"]
        nee_cast, nee_occ = _sharded_hooks["nearest"], _sharded_hooks["occ"]

    def bounce_from_attrs(d, attrs, state, chain_b):
        illum = None
        if nee:
            # its shadow rays' any-hit cast is stage cast
            illum = _direct_illumination(scene, nee_cast, attrs, light_direction, point_lights,
                                         exact, True, occ_cast=nee_occ, shadow_floor=0.0)
        return path_bounce(scene, d, attrs, state, key, chain_b, illum, **shading)

    def run_bounces(d, a0, chain):
        """Bounce chain from the primary rays ``d`` and attributes to the
        radiance (the ``bounce`` stage, its casts and samples stages of
        their own); bounce b draws with the key's chain ``chain + (b,)``."""
        with stage("bounce"):
            state, (o, d) = bounce_from_attrs(d, a0, None, chain + (0,))
            for b in range(1, max_bounces + 1):
                if fast_tail and b == max_bounces:
                    with stage("cast"):
                        occ = tail_occ(scene, o.contiguous(), d.contiguous())
                    state, _ = path_bounce(scene, d, occ, state, tail=True, **shading)
                    break
                state, (o, d) = bounce_from_attrs(d, attrs_bounce(o, d), state, chain + (b,))
            return state[0]

    dof = lens_radius > 0.0
    if samples > 1 and sample_batch and not dof:
        # one primary cast; every sample's bounces in one wavefront, the
        # primary rays and attributes expanded over the samples
        a0 = attrs_primary(origin, directions)
        bc = lambda x: x[None].expand((samples,) + x.shape)
        a0 = type(a0)(*(bc(x) for x in a0))
        radiance = run_bounces(bc(directions), a0, ())
        with stage("output"):
            return radiance.mean(dim=0)

    # sample s draws bounce b with split(split(key, samples)[s],
    # max_bounces + 2)[b], the chain (s, b), and its lens with the last of
    # those keys
    if dof:
        with stage("raygen"):
            right, up = lens_basis(directions, exact)
            sample_keys = prng.split(key, samples)
    else:
        attrs0 = attrs_primary(origin, directions)
    with stage("output"):
        total = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    for s in range(samples):
        d0 = directions
        if dof:
            with stage("raygen"):  # its draws are stage sample
                lens_key = prng.split(sample_keys[s], max_bounces + 2)[-1]
                r = torch.sqrt(prng.uniform(lens_key, shape)) * lens_radius
                # an independent angle stream folded from the same key
                phi = prng.uniform(prng.fold_in(lens_key, 1), shape, 0.0, 2.0 * math.pi)
                off = ((r * torch.cos(phi))[..., None] * right
                       + (r * torch.sin(phi))[..., None] * up)
                focal = origin + directions * focus_distance
                o0 = origin.expand(directions.shape) + off
                d0 = normalize(focal - o0, exact=exact)
            a0 = attrs_primary(o0, d0)
        else:
            a0 = attrs0
        radiance = run_bounces(d0, a0, (s,))
        with stage("output"):
            total = total + radiance
    with stage("output"):
        return total / samples


def render_ao(scene, origin, directions, key, samples: int = 8, radius: float = 1.0,
              backend: str = "cuda", exact: bool = True,
              normal_mode: str = "reference") -> torch.Tensor:
    """Ambient occlusion ``[...]`` f32 in [0, 1]: the share of ``samples``
    cosine-weighted directions above each primary hit whose nearest hit
    is not within ``radius`` (a distance-bounded query, so the
    nearest-hit cast); miss pixels are fully open. The primary cast
    carries normals (``want_normals``), the sample casts nothing and are
    bounded by the radius (``get_cast_fn``'s ``t_max``: K1's and K2's
    walks pop no box beyond it), which leaves ``hit.t < radius`` as it
    was on every backend."""
    cast0 = get_cast_fn(backend, want_normals=True)
    cast = get_cast_fn(backend, t_max=radius)
    directions = torch.as_tensor(directions, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32)
    shape = directions.shape[:-1]
    with stage("cast"):
        hit = cast0(scene, origin, directions)
    with stage("attrs"):
        attrs = hit_attributes(scene, origin, directions, hit, exact=exact,
                               normal_mode=normal_mode)
    with stage("bounce"):
        total = torch.zeros(shape, dtype=torch.float32, device=directions.device)
    key = key.to(directions.device)
    for s in range(samples):
        d = sample_cosine(key, (s,), attrs.normal, exact)
        with stage("cast"):
            o, dd = park_dead_rays(attrs.location + d * SHADOW_EPS, d, attrs.hit)
            hit = cast(scene, o, dd)
        with stage("bounce"):
            occluded = hit.t < radius
            total = total + torch.where(attrs.hit, 1.0 - occluded.to(torch.float32), 1.0)
    with stage("output"):
        return total / samples


def to_u8(radiance: torch.Tensor) -> torch.Tensor:
    """Float radiance -> uint8 with the reference's truncating cast,
    clamped to the displayable range."""
    return torch.clamp(radiance * 255.0, 0.0, 255.0).to(torch.uint8)


def tonemap(radiance: torch.Tensor, mode: str = "none", exposure: float = 1.0) -> torch.Tensor:
    """HDR -> display mapping ahead of the uint8 cast: ``none`` (linear
    times exposure), ``reinhard`` (x / (1 + x)) or ``aces`` (Narkowicz's
    fit), the last two followed by a 1/2.2 gamma."""
    x = radiance * exposure
    if mode == "none":
        return x
    if mode == "reinhard":
        y = x / (1.0 + x)
    elif mode == "aces":
        y = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    else:
        raise ValueError(f"unknown tonemap mode {mode!r}")
    return torch.pow(torch.clamp(y, min=0.0), 1.0 / 2.2)
