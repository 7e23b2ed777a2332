"""The frame stages' kernels S1 (raygen), S2 (hit attributes), S3
(primary shade), S4 (sample), S5 (Whitted shade) and S6 (path bounce) on
the CPU: their per-ray code built for
the host (``kernels/csrc/frame_host.cpp``, the ``frame.cuh`` the card
runs) against the plain versions and the JAX package, and the routers.

Inputs are small (at most 48x40 rays) and made from the scenes' seeded
recipes and numpy poses. Tolerances:
  * host build against the plain version with the same elementary
    functions (``same_libm``: the C library's atanf, atan2f, asinf, log2f,
    sinf, cosf and powf and an IEEE sqrt substituted for PyTorch's CPU ones, rsqrt as 1/sqrt
    as ATen's CPU kernel takes it): every field bit for bit, misses
    included. This holds the kernels' operation order, which on the card
    meets the plain version's own functions;
  * host build against the plain version as it is: the CPU's vectorised
    atan, sin, cos, pow and sqrt differ from the C library's by an ulp
    now and then, so floats within ``ATOL`` = 1e-6 (relative ``RTOL`` =
    1e-5 for locations of any size); bools, integers and the u8 shade
    exact (the shade's inputs are the same tensors);
  * against the JAX package (XLA on the CPU): floats within ``ATOL`` and
    ``RTOL``, integers exact, hit masks exact; the u8 shade of the same
    attributes exact but for pixels a truncation step apart at most
    ``JAX_U8_MAX`` (XLA contracts FMAs, which moves the cosine by ulps).
"""

import ctypes
import dataclasses
import functools
import math
import shutil

import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
import tpu_raytracer.scene as js
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.renderer import Hit as JaxHit
from tpu_raytracer.render.renderer import HitAttributes as JaxAttrs
from tpu_raytracer.render.integrators import PointLight as JaxPointLight
from tpu_raytracer.render.renderer import hit_attributes as jax_hit_attributes
from tpu_raytracer.render.shade import shade_primary as jax_shade_primary
from tpu_raytracer_torch import scene as ts
from tpu_raytracer_torch.kernels import build, frame, traversal
from tpu_raytracer_torch.render import camera, integrators, renderer, shade
from tpu_raytracer_torch.render.camera import (
    Camera, default_intrinsics, generate_rays, generate_rays_torch, reference_calibration,
)
from tpu_raytracer_torch.render.integrators import PointLight
from tpu_raytracer_torch.render.renderer import Hit, hit_attributes, hit_attributes_torch
from tpu_raytracer_torch.render.shade import shade_primary, shade_primary_torch
from tpu_raytracer_torch.scene.scene import from_scene_arrays
from tpu_raytracer_torch.utils import prng

from test_torch_lights import vn_scenes
from test_torch_scene import compiled, jax_fields
from test_torch_texture import textured_scene

torch.set_num_threads(1)

ATOL = 1e-6
RTOL = 1e-5
JAX_U8_MAX = 4
W, H = 48, 40
# poses (x, y, z, yaw, pitch, roll) that see each scene and some sky
POSES = {
    "cube": (0.0, -3.2, 0.6, 0.15, -0.2, 0.05),
    "instances": (0.0, -3.0, 0.3, 0.0, 0.3, 0.0),
    "blob3": (0.1, -3.0, 0.3, 0.1, -0.1, 0.0),
    "vn": (-0.5, -4.0, 0.0, 0.0, 0.0, 0.0),
}
# two point lights over config 4's floor and the demo's board
POINT_LIGHTS = (PointLight((0.0, 2.0, 2.0), 4.0), PointLight((1.5, -1.0, 2.5), 6.0))


@pytest.fixture(scope="module", autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@functools.lru_cache(maxsize=None)
def scene(name: str):
    """(JAX arrays, port scene built from them, camera) of ``cube`` (config
    1: textured, one instance), ``instances`` (config 4: four posed
    instances, a TLAS), ``blob3`` (untextured), ``vn`` (vertex normals,
    a nonuniformly scaled instance) or ``sky_demo`` (the app's textured
    demo scene with a mip-mapped odd-sized texture and the sky map)."""
    if name == "sky_demo":
        cam = Camera.looking(W, H, fov_deg=60.0, pose=[-1.0, -4.0, 2.0, 0, 0, 0])
        return (textured_scene(js, True).compile(),
                textured_scene(ts, True).compile(device="cpu"), cam)
    if name == "cube":
        ja, _ = jscenes.scene_cube(W)
    elif name == "instances":
        ja, _ = jscenes.scene_instances(W, H)
    elif name == "blob3":
        ja, _ = compiled("blob3", "jax")
    else:
        ja = None
    cam = Camera(W, H, default_intrinsics(W, H), pose=np.asarray(POSES[name], np.float32))
    if name == "vn":
        ja, sc = vn_scenes()  # jax_fields has no tri_vnorm
        assert sc.tri_vnorm is not None
        return ja, sc, cam
    return ja, from_scene_arrays(jax_fields(ja), device="cpu"), cam


def ray_args(cam: Camera):
    p = cam.ray_params("cpu")
    return p["K_inv"], p["D"], p["pose"], p["inv_pose"]


def fisheye_camera():
    K, D = reference_calibration(W, H)
    return Camera(W, H, K, D, pose=np.array([0.3, -2.0, 0.5, 0.4, -0.25, 0.1], np.float32))


def bits(x: torch.Tensor) -> np.ndarray:
    x = x.contiguous()
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).numpy()


def assert_bitwise(got, want):
    assert type(got) is type(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))


_LIBM = ctypes.CDLL("libm.so.6")
for _f, _n in (("atanf", 1), ("sinf", 1), ("cosf", 1), ("powf", 2), ("atan2f", 2), ("asinf", 1),
               ("log2f", 1)):
    getattr(_LIBM, _f).restype = ctypes.c_float
    getattr(_LIBM, _f).argtypes = [ctypes.c_float] * _n


def _libm(name, x, *args):
    fn = getattr(_LIBM, name)
    a = x.contiguous().numpy()
    out = np.array([fn(float(v), *args) for v in a.reshape(-1)], np.float32)
    return torch.from_numpy(out.reshape(a.shape))


def _libm2(name, x, y):
    fn = getattr(_LIBM, name)
    a, b = np.broadcast_arrays(x.contiguous().numpy(), y.contiguous().numpy())
    out = np.array([fn(float(u), float(v)) for u, v in zip(a.reshape(-1), b.reshape(-1))],
                   np.float32)
    return torch.from_numpy(out.reshape(a.shape))


@pytest.fixture
def same_libm(monkeypatch):
    """PyTorch's CPU atan, atan2, asin, log2, sin, cos, ``x ** p`` (p not
    2 or 3, which ATen takes as products), sqrt and rsqrt replaced by the
    C library's functions the host build calls."""
    pow_ = torch.Tensor.__pow__

    def power(x, p):
        if isinstance(p, (int, float)) and p not in (2, 3):
            return _libm("powf", x, float(p))
        return pow_(x, p)

    monkeypatch.setattr(torch, "atan", lambda x: _libm("atanf", x))
    monkeypatch.setattr(torch, "atan2", lambda x, y: _libm2("atan2f", x, y))
    monkeypatch.setattr(torch, "asin", lambda x: _libm("asinf", x))
    monkeypatch.setattr(torch, "log2", lambda x: _libm("log2f", x))
    monkeypatch.setattr(torch, "sin", lambda x: _libm("sinf", x))
    monkeypatch.setattr(torch, "cos", lambda x: _libm("cosf", x))
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    monkeypatch.setattr(torch, "rsqrt",
                        lambda x: torch.from_numpy(np.float32(1.0) / np.sqrt(x.numpy())))
    monkeypatch.setattr(torch.Tensor, "__pow__", power)


# ---------------------------------------------------------------------------
# S1 raygen
# ---------------------------------------------------------------------------

CAMERAS = {"pinhole": lambda: scene("cube")[2], "fisheye": fisheye_camera,
           "instances": lambda: scene("instances")[2]}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_raygen_host_build_matches_plain_bitwise(same_libm, cam, exact):
    c = CAMERAS[cam]()
    got = frame.generate_rays_host(W, H, *ray_args(c), exact=exact)
    want = generate_rays_torch(W, H, *ray_args(c), exact=exact)
    assert got[1].shape == (H, W, 3)
    assert_bitwise(got, want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_raygen_host_build_matches_plain_and_jax(cam, exact):
    c = CAMERAS[cam]()
    args = ray_args(c)
    o, d = frame.generate_rays_host(W, H, *args, exact=exact)
    po, pd = generate_rays_torch(W, H, *args, exact=exact)
    jo, jd = jax_generate_rays(W, H, *(a.numpy() for a in args), exact=exact)
    np.testing.assert_array_equal(o.numpy(), po.numpy())
    np.testing.assert_allclose(d.numpy(), pd.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# S2 hit attributes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rays_and_hits(name: str, carry: str):
    """(scene, origin, directions, Hit) of ``name``'s primary rays cast by
    the plain K1/K3 with the carried fields ``carry`` (``none`` for the
    redo, ``uv_n``, ``n``, ``uv``)."""
    _, sc, cam = scene(name)
    o, d = generate_rays_torch(W, H, *ray_args(cam))
    h = traversal.cast_rays(sc, o, d, want_normals="n" in carry, carry=carry != "none")
    if carry == "uv" or (carry == "n" and h.u is not None):
        h = h._replace(u=None, v=None) if carry == "n" else h._replace(n=None)
    hit = h.tri >= 0
    assert hit.any() and (~hit).any(), "the rays must hit and miss"
    return sc, o, d, h


ATTR_CASES = [("cube", "none"), ("cube", "uv_n"), ("cube", "uv"), ("cube", "n"),
              ("instances", "none"), ("instances", "uv_n"), ("instances", "n"),
              ("blob3", "none"), ("blob3", "n"), ("vn", "none"), ("vn", "n")]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
@pytest.mark.parametrize("name,carry", ATTR_CASES)
def test_attributes_host_build_matches_plain_bitwise(same_libm, name, carry, normal_mode,
                                                     exact):
    sc, o, d, h = rays_and_hits(name, carry)
    if carry != "none":
        assert (h.u is not None) == ("uv" in carry) and (h.n is not None) == ("n" in carry)
    got = frame.hit_attributes_host(sc, o, d, h, exact, normal_mode)
    want = hit_attributes_torch(sc, o, d, h, exact, normal_mode)
    assert got.t is h.t
    assert_bitwise(got, want)


def test_attributes_host_build_takes_per_ray_origins(same_libm):
    """Secondary rays: an origin per ray, the redo and the carried branch."""
    sc, o, d, h = rays_and_hits("instances", "uv_n")
    at = hit_attributes_torch(sc, o, d, h)
    o2 = at.location + at.normal * 1e-3
    d2 = -d
    for carry in (False, True):
        h2 = traversal.cast_rays(sc, o2, d2, want_normals=True, carry=carry)
        assert_bitwise(frame.hit_attributes_host(sc, o2, d2, h2),
                       hit_attributes_torch(sc, o2, d2, h2))


@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
@pytest.mark.parametrize("name,carry", [("cube", "uv_n"), ("instances", "none"),
                                        ("instances", "uv_n"), ("vn", "none"),
                                        ("blob3", "n")])
def test_attributes_host_build_matches_plain_and_jax(name, carry, normal_mode):
    ja = scene(name)[0]
    sc, o, d, h = rays_and_hits(name, carry)
    got = frame.hit_attributes_host(sc, o, d, h, normal_mode=normal_mode)
    plain = hit_attributes_torch(sc, o, d, h, normal_mode=normal_mode)
    jhit = JaxHit(*(None if x is None else x.numpy() for x in h))
    want = jax_hit_attributes(ja, o.numpy(), d.numpy(), jhit, normal_mode=normal_mode)
    hit = got.hit.numpy()
    for ref in (plain, want):
        np.testing.assert_array_equal(hit, np.asarray(ref.hit))
        np.testing.assert_array_equal(got.material.numpy(), np.asarray(ref.material))
        np.testing.assert_array_equal(got.inst.numpy(), np.asarray(ref.inst))
        for key in ("location", "normal", "uv"):
            np.testing.assert_allclose(getattr(got, key).numpy()[hit],
                                       np.asarray(getattr(ref, key))[hit], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    # misses: the plain version's values (JAX's carry no meaning there)
    for key in ("location", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, key).numpy(), getattr(plain, key).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# S3 primary shade
# ---------------------------------------------------------------------------

SHADE_CASES = [("cube", "flat"), ("cube", "lambert"), ("blob3", "lambert_shadow"),
               ("cube", "blinn_phong"), ("instances", "flat"), ("instances", "lambert"),
               ("instances", "lambert_shadow"), ("instances", "blinn_phong"),
               ("blob3", "lambert"), ("vn", "blinn_phong")]


# (scene, mode, texture filter, point lights) beyond SHADE_CASES: the sky
# map, the bilinear and trilinear filters and point lights
SHADE_CONFIG_CASES = [("sky_demo", "flat", "nearest", 0), ("sky_demo", "flat", "bilinear", 0),
                      ("sky_demo", "flat", "trilinear", 0), ("sky_demo", "lambert", "trilinear", 1),
                      ("sky_demo", "lambert_shadow", "bilinear", 2),
                      ("sky_demo", "blinn_phong", "trilinear", 1),
                      ("cube", "lambert", "bilinear", 0), ("cube", "flat", "trilinear", 0),
                      ("instances", "lambert", "nearest", 2),
                      ("instances", "lambert_shadow", "nearest", 1),
                      ("instances", "lambert_shadow", "nearest", 2),
                      ("instances", "blinn_phong", "nearest", 2)]


def _carry(name: str) -> str:
    return "uv_n" if name in ("cube", "instances", "sky_demo") else "n"


def shade_inputs(name: str, mode: str, exact: bool = True, point_lights: tuple = (),
                 light=shade.DEFAULT_LIGHT_DIRECTION):
    """(scene, attributes, directions, lit, occ_t, plain_kw) of ``name``'s
    primary hits for ``lambert_shadow``: ``lit`` the answer of shadow rays
    from every hit toward the light (the router's skip those with a cosine
    of 0.4 or less, whose answer cannot show, and these scenes shadow none
    of the others), so that S3 takes both answers; ``occ_t`` the point
    lights' answer as the router casts it; ``plain_kw`` the casts that hand
    the plain version the same answers."""
    sc, o, d, h = rays_and_hits(name, _carry(name))
    at = hit_attributes_torch(sc, o, d, h, exact)
    lit = occ_t = None
    plain_kw = {}
    if mode == "lambert_shadow":
        if light is not None:
            ldir = shade.light_vector(light, "cpu", exact)
            lit = shade.shadow_lit(sc, at, ldir, torch.ones_like(at.t), (), "cuda")
            assert lit[at.hit].any()
            if name in ("blob3", "instances"):
                assert (~lit[at.hit]).any()
            t = torch.where(lit, torch.tensor(3.4028235e38), torch.tensor(-3e38))
            plain_kw = {"cast_fn": lambda *_a, **_k: Hit(t, None, None),
                        "nearest_cast_fn": shade.point_shadow_cast(mode)}
        _, occ_t = shade.shadow_answers(sc, at, light, mode, exact, "cuda", point_lights)
        assert (occ_t is None) == (not point_lights)
    return sc, at, d, lit, occ_t, plain_kw


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,mode", SHADE_CASES)
def test_shade_host_build_matches_plain_bitwise(same_libm, name, mode, exact):
    sc, at, d, lit, _, plain_kw = shade_inputs(name, mode, exact)
    want = shade_primary_torch(sc, at, mode=mode, exact=exact, directions=d, **plain_kw)
    got = frame.shade_primary_host(sc, at, shade.DEFAULT_LIGHT_DIRECTION, mode, exact, d, lit)
    assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    sky = (got.numpy() == np.array([255, 204, 153], np.uint8)).all(-1)
    assert sky[~at.hit.numpy()].all()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,mode,tex_filter,n_lights", SHADE_CONFIG_CASES)
def test_shade_host_build_matches_plain_bitwise_on_every_config(same_libm, name, mode,
                                                                tex_filter, n_lights, exact):
    lights = POINT_LIGHTS[:n_lights]
    sc, at, d, lit, occ_t, plain_kw = shade_inputs(name, mode, exact, lights)
    want = shade_primary_torch(sc, at, mode=mode, exact=exact, directions=d,
                               point_lights=lights, tex_filter=tex_filter, **plain_kw)
    got = frame.shade_primary_host(sc, at, shade.DEFAULT_LIGHT_DIRECTION, mode, exact, d, lit,
                                   lights, occ_t, tex_filter)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if sc.has_sky:  # the sky map, not the flat colour, on the misses
        flat = (got.numpy() == np.array(shade.SKY_COLOR, np.uint8)).all(-1)
        assert not flat[~at.hit.numpy()].any()
    if lights and mode == "lambert_shadow" and name == "instances":
        # some point lights are shadowed
        dist = torch.stack([shade.point_light_vector(at, pl)[0] for pl in lights])
        assert (occ_t < dist)[:, at.hit].any()


def test_shade_host_build_takes_point_lights_without_a_directional_light(same_libm):
    sc, at, d, lit, occ_t, _ = shade_inputs("instances", "lambert_shadow", True, POINT_LIGHTS,
                                            light=None)
    assert lit is None and occ_t is not None
    want = shade_primary_torch(sc, at, None, "lambert_shadow", directions=d,
                               point_lights=POINT_LIGHTS)
    got = frame.shade_primary_host(sc, at, None, "lambert_shadow", True, d, None, POINT_LIGHTS,
                                   occ_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_shade_host_build_samples_bilinear_off_image_rows(same_libm):
    """Trilinear on rays that are not image rows (no screen derivatives)
    samples bilinear, as ``surface_color`` does."""
    sc, at, d, *_ = shade_inputs("sky_demo", "flat")
    flat = type(at)(*(x.reshape((-1,) + x.shape[2:]) for x in at))
    d1 = d.reshape(-1, 3)
    got = frame.shade_primary_host(sc, flat, None, "flat", True, d1, tex_filter="trilinear")
    np.testing.assert_array_equal(got.numpy(), shade_primary_torch(
        sc, flat, mode="flat", directions=d1, tex_filter="trilinear").numpy())
    np.testing.assert_array_equal(got.numpy(), shade_primary_torch(
        sc, flat, mode="flat", directions=d1, tex_filter="bilinear").numpy())


def _u8_close(got, want, bound: int = JAX_U8_MAX):
    off = (got != want).any(-1)
    step = np.abs(got.astype(int) - want.astype(int)).max()
    assert off.sum() <= bound and (step <= 1 or off.sum() == 0), (int(off.sum()), int(step))


@pytest.mark.parametrize("name,mode", SHADE_CASES)
def test_shade_host_build_matches_plain_and_jax(name, mode):
    sc, at, d, lit, _, plain_kw = shade_inputs(name, mode)
    ja = scene(name)[0]
    light = shade.DEFAULT_LIGHT_DIRECTION
    jcast = None
    if mode == "lambert_shadow":
        # the same shadow answer on both sides: JAX's cast through a cast_fn
        # that returns the port's
        occ_t = np.where(lit.numpy(), np.float32(3.4028235e38), np.float32(-3e38))
        jcast = lambda *_a, **_k: JaxHit(occ_t, None, None)
    plain = shade_primary_torch(sc, at, mode=mode, directions=d, **plain_kw)
    got = frame.shade_primary_host(sc, at, light, mode, True, d, lit)
    jat = JaxAttrs(*(x.numpy() for x in at))
    want = np.asarray(jax_shade_primary(ja, jat, light, mode, directions=d.numpy(),
                                        cast_fn=jcast))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    _u8_close(got.numpy(), want)


@pytest.mark.parametrize("name,mode,tex_filter,n_lights",
                         [c for c in SHADE_CONFIG_CASES if c[1] != "lambert_shadow"])
def test_shade_host_build_on_every_config_matches_plain_and_jax(name, mode, tex_filter,
                                                                n_lights):
    """The configs with no shadow rays (JAX casts its own) against the
    plain version as it is and JAX: both within ``JAX_U8_MAX`` pixels a
    step apart (the sky map's atan2 and asin and the LOD's log2 are the
    CPU's vectorised ones on the plain side, XLA's on JAX's)."""
    lights = POINT_LIGHTS[:n_lights]
    sc, at, d, *_ = shade_inputs(name, mode, True, lights)
    light = shade.DEFAULT_LIGHT_DIRECTION
    got = frame.shade_primary_host(sc, at, light, mode, True, d, None, lights, None, tex_filter)
    plain = shade_primary_torch(sc, at, light, mode, directions=d, point_lights=lights,
                                tex_filter=tex_filter)
    jat = JaxAttrs(*(x.numpy() for x in at))
    jlights = tuple(JaxPointLight(pl.position, pl.intensity) for pl in lights)
    want = np.asarray(jax_shade_primary(scene(name)[0], jat, light, mode, directions=d.numpy(),
                                        point_lights=jlights, tex_filter=tex_filter))
    _u8_close(got.numpy(), plain.numpy())
    _u8_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# S4 sample
# ---------------------------------------------------------------------------

# frame keys: small, past 32 bits, and with both words near 2**32
SAMPLE_KEYS = (0, 7, 2 ** 40 + 12345, 2 ** 63 - 5)


def sample_normals(shape) -> torch.Tensor:
    """Unit normals ``shape + (3,)`` from a seeded generator, the first
    rows set to the basis' edge cases: n.z = +1, -1, -0.0 and +0.0, and
    the zero normal S2 gives a miss."""
    g = torch.Generator().manual_seed(11)
    n = torch.nn.functional.normalize(torch.randn(shape + (3,), generator=g), dim=-1)
    flat = n.view(-1, 3)
    flat[:6] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.6, 0.8, -0.0],
                             [0.8, -0.6, 0.0], [0.0, 0.0, 0.0], [-0.0, 0.0, -0.0]])
    return n


def sample_normal_layout(layout: str) -> torch.Tensor:
    """AO's normals (one per pixel, contiguous), the path tracer's batch
    (samples first) contiguous, or its first bounce's: one per pixel
    expanded over the samples with stride 0."""
    if layout == "ao":
        return sample_normals((H, W))
    if layout == "path":
        return sample_normals((2, H, W))
    n = sample_normals((H, W))[None].expand(2, H, W, 3)
    assert n.stride(0) == 0
    return n


@pytest.mark.parametrize("lobe", [False, True])
@pytest.mark.parametrize("chain", [(5,), (2, 1)])
@pytest.mark.parametrize("layout", ["ao", "path", "path_expanded"])
@pytest.mark.parametrize("exact", [True, False])
def test_sample_host_build_matches_plain_bitwise(same_libm, exact, layout, chain, lobe):
    n = sample_normal_layout(layout)
    key = prng.PRNGKey(SAMPLE_KEYS[2])
    got = frame.sample_cosine_host(key, chain, n, exact, lobe)
    want = integrators.sample_cosine_torch(key, chain, n, exact, lobe)
    if not lobe:
        got, want = (got,), (want,)
    assert got[0].shape == n.shape and got[0].is_contiguous()
    assert len(got) == len(want)
    for a, b in zip(got, want):  # NaN patterns included: the bits themselves
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))
    d = got[0].reshape(-1, 3)
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), 1.0, atol=2e-3)
    n_flat = n.reshape(-1, 3)
    lit = n_flat.norm(dim=-1) > 0
    assert ((d * n_flat).sum(-1)[lit] >= -1e-6).all()  # above each surface


@pytest.mark.parametrize("seed", SAMPLE_KEYS)
def test_split_is_fold_in(seed):
    """``split(key, n)[i]`` is ``fold_in(key, i)``, the equality S4's
    chains rest on, for every n and i the integrators take."""
    key = prng.PRNGKey(seed)
    for n in (2, 3, 4, 8, 9):
        keys = prng.split(key, n)
        for i in range(n):
            np.testing.assert_array_equal(keys[i].numpy(), prng.fold_in(key, i).numpy())


@pytest.mark.parametrize("site", ["ao", "path_batched", "path_sequential"])
def test_sample_chains_draw_the_integrators_split_keys(site):
    """Each call site's chain draws what its split keys drew: AO's
    ``split(key, 8)[s]``, the batched path tracer's ``split(key, 3)[b]``
    with the lobe key ``fold_in(key_b, 3)``, the sequential one's
    ``split(split(key, 2)[s], 4)[b]``."""
    key = prng.PRNGKey(SAMPLE_KEYS[3])
    n = sample_normals((H, W))
    for chain in {"ao": [(s,) for s in range(8)], "path_batched": [(b,) for b in range(3)],
                  "path_sequential": [(s, b) for s in range(2) for b in range(3)]}[site]:
        k = prng.split(key, 8 if site == "ao" else (2 if len(chain) == 2 else 3))[chain[0]]
        if len(chain) == 2:
            k = prng.split(k, 4)[chain[1]]
        d, u = integrators.sample_cosine_torch(key, chain, n, True, lobe=True)
        np.testing.assert_array_equal(bits(d), bits(integrators._cosine_sample(k, n, True)))
        np.testing.assert_array_equal(bits(u), bits(prng.uniform(prng.fold_in(k, 3), (H, W))))


def test_two_pi_rounds_as_aten_rounds_a_python_scalar():
    """``2.0 * math.pi * u`` multiplies by the double rounded once to f32,
    the constant S4 takes (``frame.cuh`` kTwoPi)."""
    u = prng.uniform(prng.PRNGKey(3), (4096,))
    want = u.numpy() * np.float32(2.0 * math.pi)
    np.testing.assert_array_equal(bits(2.0 * math.pi * u), want.view(np.int32))
    assert np.float32(2.0 * math.pi).view(np.int32) == 0x40C90FDB


@pytest.mark.parametrize("mode", ["ao", "path_batched", "path_sequential", "path_nee",
                                  "path_emissive", "path_dof"])
def test_integrators_through_the_host_build_render_the_plain_frames(same_libm, monkeypatch,
                                                                    mode):
    """AO and path frames with ``sample_cosine`` on S4's host build, and the
    path frames' ``path_bounce`` on S6's (the router's kernel path: S4's
    draw, then S6): bit for bit the frames through the plain versions. The
    path frames: the batched wavefront (its first bounce on rows expanded
    over the samples) and the sequential samples, each with the fast tail;
    NEE with a point light and an emissive material, both without it; depth
    of field (per-ray primary rows)."""
    sc, o, d, _ = rays_and_hits("instances", "uv_n")
    key = prng.PRNGKey(SAMPLE_KEYS[1])
    if mode == "path_emissive":
        k = sc.mat_albedo.shape[0]
        sc = dataclasses.replace(sc, mat_illumination=torch.tensor(
            [0.5 if i == 1 else 0.0 for i in range(k)]), has_emissive=True)
    kw = {"path_nee": dict(light_direction=shade.DEFAULT_LIGHT_DIRECTION,
                           point_lights=POINT_LIGHTS[:1], sun_intensity=2.0),
          "path_dof": dict(lens_radius=0.05, focus_distance=3.0),
          "path_sequential": dict(sample_batch=False)}.get(mode, {})
    if mode == "ao":
        render = lambda: integrators.render_ao(sc, o, d, key, samples=3, backend="cuda")
    else:
        render = lambda: integrators.render_path_traced(
            sc, o, d, key, max_bounces=2, samples=2, backend="cuda", sky_strength=1.5, **kw)
    want = render()
    calls, bounces = [], []

    def host(*args, **kw):
        calls.append(args[1])
        return frame.sample_cosine_host(*args, **kw)

    def bounce_host(scene, d, attrs, state=None, key=None, chain=(), illum=None, exact=True,
                    tex_filter="nearest", sky_strength=1.0, light_scale=0.0, tail=False):
        bounces.append((tail, illum is not None, d.stride(0) == 0))
        samples = None if tail else integrators.sample_cosine(key, chain, attrs.normal, exact,
                                                              lobe=True)
        return frame.path_bounce_host(scene, d, attrs, samples, illum, state, exact, tex_filter,
                                      sky_strength, light_scale, tail)

    monkeypatch.setattr(integrators, "sample_cosine", host)
    monkeypatch.setattr(integrators, "path_bounce", bounce_host)
    got = render()
    np.testing.assert_array_equal(bits(got), bits(want))
    batched = [(0,), (1,)]
    assert calls == {"ao": [(0,), (1,), (2,)], "path_batched": batched,
                     "path_sequential": [(0, 0), (0, 1), (1, 0), (1, 1)],
                     "path_nee": batched + [(2,)], "path_emissive": batched + [(2,)],
                     "path_dof": [(0, 0), (0, 1), (1, 0), (1, 1)]}[mode]
    # (tail, NEE's term given, directions expanded over the samples) a call
    first, later, tail = (False, False, True), (False, False, False), (True, False, False)
    per_sample = [later, later, tail]
    assert bounces == {"ao": [], "path_batched": [first, later, tail],
                       "path_sequential": 2 * per_sample, "path_dof": 2 * per_sample,
                       "path_nee": [(False, True, True), (False, True, False),
                                    (False, True, False)],
                       "path_emissive": [first, later, later]}[mode]


# ---------------------------------------------------------------------------
# S5 Whitted shade
# ---------------------------------------------------------------------------

# (scene, texture filter): albedo alone under the flat sky (blob3), config
# 4's textured floor nearest and bilinear, the demo's textures under its sky
# map nearest and trilinear (which samples bilinear: a bounce has no
# screen derivatives)
WHITTED_CASES = [("blob3", "nearest"), ("instances", "nearest"), ("instances", "bilinear"),
                 ("sky_demo", "nearest"), ("sky_demo", "trilinear")]


@functools.lru_cache(maxsize=None)
def whitted_scene(name: str):
    """``name``'s scene with its materials' reflectivity 0.8, 0.5 and 0 in
    turn and material 1 emissive, so that rays bounce and the emission
    counts whatever the recipe's materials are."""
    sc = scene(name)[1]
    k = sc.mat_albedo.shape[0]
    return dataclasses.replace(
        sc, mat_reflectivity=torch.tensor([(0.8, 0.5, 0.0)[i % 3] for i in range(k)]),
        mat_illumination=torch.tensor([0.25 if i == 1 else 0.0 for i in range(k)]))


def _whitted_inputs(sc, o, d, hit, exact: bool):
    """(directions, attributes, light term) of one bounce: the directional
    light's shadowed cosine plus a point light's term, so that the clamp
    meets values under 0.4 and over 1."""
    attrs = hit_attributes_torch(sc, o, d, hit, exact)
    illum = integrators._direct_illumination(sc, traversal.cast_rays, attrs,
                                             shade.DEFAULT_LIGHT_DIRECTION, POINT_LIGHTS[:1],
                                             exact, True, clamp_floor=0.4)
    return d, attrs, illum


@functools.lru_cache(maxsize=None)
def whitted_bounces(name: str, exact: bool, tex_filter: str):
    """The first two bounces of ``name``'s Whitted frame: (directions,
    attributes, light term) of the primary rays, and of the reflected rays
    with the state the plain first bounce left (most of them parked)."""
    sc = whitted_scene(name)
    _, o, d, h = rays_and_hits(name, _carry(name))
    first = _whitted_inputs(sc, o, d, h, exact)
    state, (ro, rd) = integrators.whitted_shade_torch(sc, *first, None, exact, tex_filter)
    h1 = traversal.cast_rays(sc, ro, rd, want_normals=True)
    return first, _whitted_inputs(sc, ro, rd, h1, exact) + (state,)


@pytest.mark.parametrize("bounce", ["first", "middle", "last", "first_last", "inactive"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,tex_filter", WHITTED_CASES)
def test_whitted_shade_host_build_matches_plain_bitwise(same_libm, name, tex_filter, exact,
                                                        bounce):
    """S5's host build against ``whitted_shade_torch`` at the first bounce
    (no state in), a middle one (rays parked among them) and the last (no
    rays out), every output bit for bit; the state is updated in place.
    ``inactive``: the primary rays under the first bounce's state with every
    throughput 0.75, so that only the active flags keep the inactive rays'
    hits and misses out of the sums (a frame's dead rays carry 0)."""
    sc = whitted_scene(name)
    first, middle = whitted_bounces(name, exact, tex_filter)
    d, attrs, illum, state = first + (None,) if bounce.startswith("first") else middle
    if bounce == "inactive":
        d, attrs, illum = first
        state = (middle[3][0], torch.full_like(middle[3][1], 0.75), middle[3][2])
    last = bounce.endswith("last")
    want = integrators.whitted_shade_torch(sc, d, attrs, illum, state, exact, tex_filter, last)
    mine = None if state is None else tuple(x.clone() for x in state)
    got = frame.whitted_shade_host(sc, d, attrs, illum, mine, exact, tex_filter, last)
    assert_bitwise(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == last
    if not last:
        assert_bitwise(got[1], want[1])
    if state is not None:
        assert all(g is m for g, m in zip(got[0], mine))
        assert state[2].any() and (~state[2]).any()
    assert (~attrs.hit).any() and (attrs.hit.any() or name == "blob3")  # a convex blob


def test_whitted_frames_through_the_host_build_render_the_plain_frames(same_libm, monkeypatch):
    """Config 4's Whitted frame at 96x64 with each bounce's shade on S5's
    host build: bit for bit the frame through the plain version."""
    from tpu_raytracer_torch.app.scenes import scene_instances

    sc, cam = scene_instances(96, 64, device="cpu")
    p = cam.ray_params("cpu")
    o, d = generate_rays_torch(96, 64, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    render = lambda: integrators.render_whitted(sc, o, d, max_bounces=2)
    want = render()
    calls = []

    def host(*args):
        calls.append(args[-1])
        return frame.whitted_shade_host(*args)

    monkeypatch.setattr(integrators, "whitted_shade", host)
    got = render()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert calls == [False, False, True]


# ---------------------------------------------------------------------------
# S6 path bounce
# ---------------------------------------------------------------------------

# (scene, texture filter): config 5's colonnade (one albedo, the flat sky),
# config 4's textured floor among reflective, emissive and rough materials
# (nearest), and the demo's textures under its sky map (trilinear, which a
# bounce samples bilinear)
PATH_SCENES = [("colonnade", "nearest"), ("instances", "nearest"), ("sky_demo", "trilinear")]
# (bounce, layout of the primary rows, NEE): the first bounce on the rows
# expanded over 2 samples (the batched wavefront) or one per ray (the
# sequential samples, depth of field), a later bounce, and the fast tail
PATH_BOUNCES = [("first", "expanded", False), ("first", "expanded", True),
                ("first", "per_ray", False), ("first", "per_ray", True),
                ("later", "per_ray", False), ("later", "per_ray", True),
                ("later", "expanded", False), ("tail", "per_ray", False)]
PATH_SKY = 1.5  # sky_strength
PATH_LIGHT = (1.0 / math.pi) * 2.0  # light_scale: a sun of intensity 2


@functools.lru_cache(maxsize=None)
def path_scene(name: str):
    """(scene, origins, directions, Hit) of ``name``'s primary rays cast by
    the plain walk with normals. Config 4 and the demo take reflectivity
    0.7, 0.35 and 0 in turn, roughness 0, 0.3 and 1 in turn and material 1
    emissive, so that every lobe and the emission count."""
    if name == "colonnade":
        from tpu_raytracer_torch.app.scenes import scene_colonnade

        sc, cam = scene_colonnade(W, H, columns=4, segs=8, device="cpu")
        o, d = generate_rays_torch(W, H, *ray_args(cam))
    else:
        base, o, d, _ = rays_and_hits(name, "none")
        k = base.mat_albedo.shape[0]
        sc = dataclasses.replace(
            base, mat_reflectivity=torch.tensor([(0.7, 0.35, 0.0)[i % 3] for i in range(k)]),
            mat_roughness=torch.tensor([(0.0, 0.3, 1.0)[i % 3] for i in range(k)]),
            mat_illumination=torch.tensor([0.25 if i == 1 else 0.0 for i in range(k)]))
    h = traversal.cast_rays(sc, o, d, want_normals=True)
    return sc, o, d, h


def _path_light(sc, attrs, exact: bool, nee: bool):
    """NEE's light term as ``render_path_traced`` takes it (the directional
    light's shadowed cosine plus a point light), or None."""
    if not nee:
        return None
    return integrators._direct_illumination(sc, traversal.cast_rays, attrs,
                                            shade.DEFAULT_LIGHT_DIRECTION, POINT_LIGHTS[:1],
                                            exact, True, shadow_floor=0.0)


@functools.lru_cache(maxsize=None)
def path_inputs(name: str, tex_filter: str, bounce: str, layout: str, nee: bool, exact: bool):
    """(directions, attributes or the tail's Hit, state, chain, light term)
    of one bounce of ``name``'s path frame: the first on the primary rays
    (``expanded``: their rows expanded over 2 samples, stride 0), or, after
    the plain first bounce, the second bounce on its rays or the any-hit
    tail."""
    sc, o, d, h = path_scene(name)
    attrs = hit_attributes_torch(sc, o, d, h, exact)
    if layout == "expanded":
        d = d[None].expand((2,) + d.shape)
        attrs = type(attrs)(*(x[None].expand((2,) + x.shape) for x in attrs))
    key = prng.PRNGKey(SAMPLE_KEYS[2])
    if bounce == "first":
        return d, attrs, None, (0,), _path_light(sc, attrs, exact, nee)
    state, (ro, rd) = integrators.path_bounce_torch(
        sc, d, attrs, None, key, (0,), _path_light(sc, attrs, exact, nee), exact, tex_filter,
        PATH_SKY, PATH_LIGHT)
    if bounce == "tail":
        return rd, traversal.cast_rays(sc, ro, rd, occlusion=True), state, (), None
    h1 = traversal.cast_rays(sc, ro, rd, want_normals=True)
    a1 = hit_attributes_torch(sc, ro, rd, h1, exact)
    if layout == "expanded":  # the second bounce's rows of sample 0 for both
        rd = rd[:1].expand(rd.shape)
        a1 = type(a1)(*(x[:1].expand(x.shape) for x in a1))
    return rd, a1, state, (1,), _path_light(sc, a1, exact, nee)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("bounce,layout,nee", PATH_BOUNCES)
@pytest.mark.parametrize("name,tex_filter", PATH_SCENES)
def test_path_bounce_host_build_matches_plain_bitwise(same_libm, name, tex_filter, bounce,
                                                      layout, nee, exact):
    """S6's host build against ``path_bounce_torch`` at the first bounce
    (no state in), a later one (rays parked among them) and the fast tail,
    on primary rows expanded over the samples or one per ray, with NEE's
    light term and without: the state, updated in place, and the next rays
    bit for bit. The host build takes S4's samples as the router's kernel
    path does; the plain version draws them itself."""
    sc = path_scene(name)[0]
    d, attrs, state, chain, illum = path_inputs(name, tex_filter, bounce, layout, nee, exact)
    key = prng.PRNGKey(SAMPLE_KEYS[2])
    tail = bounce == "tail"
    shading = (exact, tex_filter, PATH_SKY, PATH_LIGHT, tail)
    want = integrators.path_bounce_torch(sc, d, attrs, state, key, chain, illum, *shading)
    samples = None if tail else integrators.sample_cosine_torch(key, chain, attrs.normal, exact,
                                                                lobe=True)
    mine = None if state is None else tuple(x.clone() for x in state)
    got = frame.path_bounce_host(sc, d, attrs, samples, illum, mine, *shading)
    assert_bitwise(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == tail
    if not tail:
        assert_bitwise(got[1], want[1])
    if state is not None:
        assert all(g is m for g, m in zip(got[0], mine))
        assert state[2].any() and (~state[2]).any()
    live = got[0][2]
    if not tail:  # rays hit and miss; the misses take the sky
        assert live.any() and (~live).any() and (got[0][0][~live] > 0).any()
    if bounce == "first" and name != "colonnade":  # the glossy lobe is taken
        u = samples[1]
        refl = sc.mat_reflectivity[attrs.material]
        assert (live & (u < refl)).any() and (live & (u >= refl)).any()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,tex_filter", PATH_SCENES[1:])
def test_path_bounce_host_build_takes_the_cosine_sample_under_the_surface(same_libm, name,
                                                                          tex_filter, exact):
    """The first bounce with every normal turned away from its ray, as a
    back face's is: the glossy lobe dips under the surface and falls back
    to the cosine sample. S6's host build bit for bit as the plain
    version."""
    sc = path_scene(name)[0]
    d, attrs, _, chain, _ = path_inputs(name, tex_filter, "first", "per_ray", False, exact)
    attrs = attrs._replace(normal=-attrs.normal)
    key = prng.PRNGKey(SAMPLE_KEYS[2])
    shading = (exact, tex_filter, PATH_SKY, PATH_LIGHT)
    want = integrators.path_bounce_torch(sc, d, attrs, None, key, chain, None, *shading)
    samples = integrators.sample_cosine_torch(key, chain, attrs.normal, exact, lobe=True)
    got = frame.path_bounce_host(sc, d, attrs, samples, None, None, *shading)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    glossy = want[0][2] & (samples[1] < sc.mat_reflectivity[attrs.material])
    under = glossy & (got[1][1] == samples[0]).all(-1)
    assert under.any() and (glossy & ~under).any()


def test_path_bounce_reads_expanded_rows_through_their_period():
    """The batched wavefront's primary rows, expanded over the samples,
    reach S6 as their first row and its period, never copied; rows of any
    other layout as contiguous tensors of every ray."""
    d, attrs, *_ = path_inputs("instances", "nearest", "first", "expanded", False, True)
    fields = [("directions", d, torch.float32, (3,)), ("hit", attrs.hit, torch.bool, ()),
              ("uv", attrs.uv, torch.float32, (2,))]
    rows, period = frame._primary_rows(d.shape[:-1], fields)
    assert period == H * W
    assert [x.data_ptr() for x in rows] == [x.data_ptr() for _, x, _, _ in fields]
    assert [x.shape for x in rows] == [(H, W, 3), (H, W), (H, W, 2)]
    fields[1] = ("hit", attrs.hit.contiguous(), torch.bool, ())
    rows, period = frame._primary_rows(d.shape[:-1], fields)
    assert period == 2 * H * W and rows[0].shape == (2, H, W, 3)
    with pytest.raises(ValueError, match="shape"):
        frame._primary_rows(d.shape[:-1], fields[:1] + [("uv", attrs.uv[..., :1],
                                                         torch.float32, (2,))])


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernel wrappers replaced by functions that fail the test."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached a kernel wrapper")

    for name in ("generate_rays_cuda", "hit_attributes_cuda", "shade_primary_cuda",
                 "sample_cosine_cuda", "whitted_shade_cuda", "path_bounce_cuda"):
        monkeypatch.setattr(frame, name, refuse)


def test_routers_take_the_plain_versions_on_the_cpu(no_kernels):
    counts = dict(build.LAUNCHES)
    cam = scene("cube")[2]
    assert_bitwise(generate_rays(W, H, *ray_args(cam)), generate_rays_torch(W, H, *ray_args(cam)))
    sc, o, d, h = rays_and_hits("cube", "uv_n")
    at = hit_attributes(sc, o, d, h, normal_mode="inverse_transpose")
    assert_bitwise(at, hit_attributes_torch(sc, o, d, h, normal_mode="inverse_transpose"))
    for mode in frame.MODES:
        np.testing.assert_array_equal(
            shade_primary(sc, at, mode=mode, directions=d).numpy(),
            shade_primary_torch(sc, at, mode=mode, directions=d).numpy())
    assert build.LAUNCHES == counts


@pytest.mark.parametrize("lobe", [False, True])
def test_sample_router_takes_the_plain_version_on_the_cpu(no_kernels, lobe):
    before = dict(build.LAUNCHES)
    key, n = prng.PRNGKey(SAMPLE_KEYS[2]), sample_normal_layout("path_expanded")
    got = integrators.sample_cosine(key, (1,), n, True, lobe)
    want = integrators.sample_cosine_torch(key, (1,), n, True, lobe)
    assert_bitwise(got if lobe else (got,), want if lobe else (want,))
    assert build.LAUNCHES == before


def test_whitted_shade_router_takes_the_plain_version_on_the_cpu(no_kernels):
    before = dict(build.LAUNCHES)
    sc = whitted_scene("instances")
    first, (d, attrs, illum, state) = whitted_bounces("instances", True, "nearest")
    for args in (first + (None,), (d, attrs, illum, state)):
        got = integrators.whitted_shade(sc, *args)
        want = integrators.whitted_shade_torch(sc, *args)
        assert_bitwise(got[0], want[0])
        assert_bitwise(got[1], want[1])
    assert build.LAUNCHES == before


@pytest.mark.parametrize("bounce", ["first", "later", "tail"])
def test_path_bounce_router_takes_the_plain_version_on_the_cpu(no_kernels, bounce):
    before = dict(build.LAUNCHES)
    sc = path_scene("instances")[0]
    d, attrs, state, chain, illum = path_inputs("instances", "nearest", bounce, "expanded"
                                                if bounce == "first" else "per_ray", True, True)
    key = prng.PRNGKey(SAMPLE_KEYS[2])
    args = (sc, d, attrs, state, key, chain, illum, True, "nearest", PATH_SKY, PATH_LIGHT,
            bounce == "tail")
    got, want = integrators.path_bounce(*args), integrators.path_bounce_torch(*args)
    assert_bitwise(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (bounce == "tail")
    if got[1] is not None:
        assert_bitwise(got[1], want[1])
    assert build.LAUNCHES == before


def test_launch_counts_name_every_kernel_and_host_runs_count_none():
    """``launch_counts()`` names the launch counts of K1-K6 and S1-S6, and
    CPU runs of S1-S6's host builds and of K6's plan move none of them:
    only launches on the card count."""
    from tpu_raytracer_torch.kernels import paged_major
    from tpu_raytracer_torch.render.compiled import launch_counts

    before = launch_counts()
    assert list(before) == ["K1", "K1_carry", "K1_bounded", "K2", "K3", "K3_carry", "K4", "K5",
                            "K6", "K6_plan", "S1", "S2", "S3", "S4", "S5", "S6"]
    assert before == build.LAUNCHES and before is not build.LAUNCHES
    sc, o, d, h = rays_and_hits("cube", "uv_n")
    o1, d1 = frame.generate_rays_host(W, H, *ray_args(scene("cube")[2]))
    at = frame.hit_attributes_host(sc, o1, d1, h)
    frame.shade_primary_host(sc, at, shade.DEFAULT_LIGHT_DIRECTION, "blinn_phong", True, d1)
    frame.sample_cosine_host(prng.PRNGKey(1), (1,), at.normal, lobe=True)
    frame.whitted_shade_host(sc, d1, at, torch.ones(H, W))
    state, _ = frame.path_bounce_host(sc, d1, at, (at.normal, torch.zeros(H, W)))
    frame.path_bounce_host(sc, d1, h, state=state, tail=True)
    pages = sc.with_paging(page_tris=32, page_nodes=64)
    _, o_t, d_t = paged_major._tile_rays(o, d)
    item_pid, item_iid, tile_start, tile_item = paged_major.page_major_plan_cuda(pages, o_t, d_t)
    assert item_pid.numel() > 0 and int(tile_start[-1]) > 0
    assert launch_counts() == before


def _global_reads(table) -> set:
    """The global names the functions under ``table`` (a ``symtable``)
    read, nested functions, lambdas and comprehensions included."""
    names = set()
    for child in table.get_children():
        if child.get_type() == "function":
            names |= {s.get_name() for s in child.get_symbols()
                      if s.is_global() and s.is_referenced()}
        names |= _global_reads(child)
    return names


def test_chip_smoke_reads_only_names_it_defines_or_imports():
    """Every global name a function of ``chip_smoke.py`` reads is defined
    or imported at the script's top level, or is a builtin. The script runs
    only on the card, so no other test would see a phase reach for a
    helper or a constant that is gone."""
    import builtins
    import pathlib
    import symtable

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    table = symtable.symtable(path.read_text(), str(path), "exec")
    top = {s.get_name() for s in table.get_symbols() if s.is_assigned() or s.is_imported()}
    top |= {"__file__", "__name__", "__doc__"}  # set on every module
    reads = _global_reads(table)
    assert {"check", "phase", "main"} <= reads | top
    assert sorted(reads - top - set(dir(builtins))) == []


def test_router_names_keep_their_signatures():
    import inspect

    for router, plain in ((camera.generate_rays, camera.generate_rays_torch),
                          (renderer.hit_attributes, renderer.hit_attributes_torch),
                          (shade.shade_primary, shade.shade_primary_torch),
                          (integrators.sample_cosine, integrators.sample_cosine_torch),
                          (integrators.whitted_shade, integrators.whitted_shade_torch),
                          (integrators.path_bounce, integrators.path_bounce_torch)):
        assert inspect.signature(router) == inspect.signature(plain)


def test_router_modules_name_every_module_that_binds_a_router():
    """``frame.ROUTER_MODULES`` (what swaps in the plain versions patches)
    is every module of the package that binds a router by name."""
    import importlib
    import pkgutil

    import tpu_raytracer_torch

    routers = {"generate_rays": camera.generate_rays, "hit_attributes": renderer.hit_attributes,
               "shade_primary": shade.shade_primary,
               "sample_cosine": integrators.sample_cosine,
               "whitted_shade": integrators.whitted_shade,
               "path_bounce": integrators.path_bounce}
    bound = set()
    for info in pkgutil.walk_packages(tpu_raytracer_torch.__path__, "tpu_raytracer_torch."):
        mod = importlib.import_module(info.name)
        if any(getattr(mod, k, None) is fn for k, fn in routers.items()):
            bound.add(info.name.removeprefix("tpu_raytracer_torch."))
    assert bound == set(frame.ROUTER_MODULES)


def test_shade_router_casts_the_shadow_rays_the_plain_version_casts():
    """``shadow_answers`` (what the router hands S3) casts what
    ``compute_illumination`` casts: the directional rays where the cosine
    is above 0.4, all hits with point lights, and none outside
    ``lambert_shadow``."""
    sc, o, d, h = rays_and_hits("instances", "uv_n")
    at = hit_attributes_torch(sc, o, d, h)
    seen = []

    def cast(scene_, ro, rd):
        seen.append(rd)
        return traversal.cast_rays(scene_, ro, rd, carry=False)

    for mode in ("flat", "lambert", "blinn_phong"):
        assert shade.shadow_answers(sc, at, mode=mode, point_lights=POINT_LIGHTS,
                                    cast_fn=cast, nearest_cast_fn=cast) == (None, None)
    assert not seen
    light = shade.light_vector(shade.DEFAULT_LIGHT_DIRECTION, "cpu")
    live = lambda rd: ~(rd == 1.0).all(-1)  # parked rays point along (1, 1, 1)
    for lights, want in (((), at.hit & (shade.dot(at.normal, light) > 0.4)),
                         (POINT_LIGHTS, at.hit)):
        seen.clear()
        lit, occ_t = shade.shadow_answers(sc, at, mode="lambert_shadow", point_lights=lights,
                                          cast_fn=cast, nearest_cast_fn=cast)
        assert len(seen) == 1 + len(lights) and lit.shape == at.hit.shape
        assert torch.equal(live(seen[0]), want)
        assert (occ_t is None) == (not lights)
    with pytest.raises(ValueError, match="nearest_cast_fn"):
        shade.shadow_answers(sc, at, mode="lambert", point_lights=POINT_LIGHTS, cast_fn=cast)


def test_wrappers_reject_bad_dtypes_shapes_and_devices():
    args = ray_args(scene("cube")[2])
    with pytest.raises(ValueError, match="float32"):
        frame.generate_rays_cuda(W, H, args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        frame.generate_rays_cuda(W, H, args[0], torch.zeros(5), *args[2:])
    with pytest.raises(ValueError, match="cuda"):
        frame.generate_rays_cuda(W, H, *args)
    with pytest.raises(ValueError, match="positive"):
        frame.generate_rays_host(0, H, *args)
    sc, o, d, h = rays_and_hits("cube", "uv_n")
    with pytest.raises(ValueError, match="int32"):
        frame.hit_attributes_cuda(sc, o, d, h._replace(tri=h.tri.long()))
    with pytest.raises(ValueError, match="shape"):
        frame.hit_attributes_cuda(sc, o, d, h._replace(t=h.t[:-1]))
    with pytest.raises(ValueError, match="together"):
        frame.hit_attributes_cuda(sc, o, d, h._replace(v=None))
    with pytest.raises(ValueError, match="normal_mode"):
        hit_attributes(sc, o, d, h, normal_mode="transpose")
    with pytest.raises(ValueError, match="cuda"):
        frame.hit_attributes_cuda(sc, o, d, h)
    at = hit_attributes_torch(sc, o, d, h)
    with pytest.raises(ValueError, match="shape"):
        frame.shade_primary_cuda(sc, at._replace(uv=at.uv[..., :1]), None)
    with pytest.raises(ValueError, match="int64"):
        frame.shade_primary_cuda(sc, at._replace(material=at.material.int()), None)
    with pytest.raises(ValueError, match="lit"):
        frame.shade_primary_host(sc, at, shade.DEFAULT_LIGHT_DIRECTION, "lambert_shadow")
    with pytest.raises(ValueError, match="modes"):
        frame.shade_primary_host(sc, at, None, "phong")
    with pytest.raises(ValueError, match="filter"):
        frame.shade_primary_host(sc, at, None, tex_filter="cubic")
    with pytest.raises(ValueError, match="point_occ_t"):
        frame.shade_primary_host(sc, at, None, "lambert_shadow", point_lights=POINT_LIGHTS)
    with pytest.raises(ValueError, match="shape"):
        frame.shade_primary_host(sc, at, None, "lambert_shadow", point_lights=POINT_LIGHTS,
                                 point_occ_t=torch.zeros(1, H, W))
    with pytest.raises(ValueError, match="int64"):
        frame.shade_primary_host(sc, at._replace(inst=at.inst.int()), None,
                                 tex_filter="trilinear")
    with pytest.raises(ValueError, match="cuda"):
        frame.shade_primary_cuda(sc, at, None)
    illum = torch.ones(H, W)
    with pytest.raises(ValueError, match="float32"):
        frame.whitted_shade_host(sc, d, at, illum.double())
    with pytest.raises(ValueError, match="shape"):
        frame.whitted_shade_host(sc, d, at._replace(uv=at.uv[..., :1]), illum)
    with pytest.raises(ValueError, match="int64"):
        frame.whitted_shade_host(sc, d, at._replace(material=at.material.int()), illum)
    with pytest.raises(ValueError, match="filter"):
        frame.whitted_shade_host(sc, d, at, illum, tex_filter="cubic")
    state, _ = frame.whitted_shade_host(sc, d, at, illum)
    with pytest.raises(ValueError, match="contiguous"):  # updated in place: no copy
        frame.whitted_shade_host(sc, d, at, illum, (state[0].transpose(0, 1).contiguous()
                                                    .transpose(0, 1), *state[1:]))
    with pytest.raises(ValueError, match="shape"):
        frame.whitted_shade_host(sc, d, at, illum, (state[0], state[1], state[2][:-1]))
    with pytest.raises(ValueError, match="cuda"):
        frame.whitted_shade_cuda(sc, d, at, illum)


def test_sample_wrapper_rejects_bad_inputs():
    key, n = prng.PRNGKey(1), sample_normals((4, 5))
    with pytest.raises(ValueError, match="chain"):
        frame.sample_cosine_host(key, (1, 2, 3, 4, 5), n)
    with pytest.raises(ValueError, match="chain"):
        frame.sample_cosine_host(key, (2 ** 32,), n)
    with pytest.raises(ValueError, match="float32"):
        frame.sample_cosine_host(key, (1,), n.double())
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        frame.sample_cosine_host(key, (1,), n[..., :2])
    with pytest.raises(ValueError, match="int64"):
        frame.sample_cosine_host(key.int(), (1,), n)
    with pytest.raises(ValueError, match="shape"):
        frame.sample_cosine_host(prng.split(key, 2), (1,), n)
    with pytest.raises(ValueError, match="cuda"):
        frame.sample_cosine_cuda(key, (1,), n)
    d, u = frame.sample_cosine_host(key, (), n[:0], lobe=True)  # no ray: no launch
    assert d.shape == (0, 5, 3) and u.shape == (0, 5)


def test_path_bounce_wrapper_rejects_bad_inputs():
    """S6's wrappers refuse a wrong dtype, shape or device of the rays, the
    attributes, S4's samples, the light term and the state (updated in
    place: no copy may stand in for it), a bounce without samples, and an
    unknown filter; ``path_bounce_cuda`` refuses CPU tensors."""
    sc = path_scene("instances")[0]
    d, attrs, _, chain, illum = path_inputs("instances", "nearest", "first", "per_ray", True,
                                            True)
    samples = integrators.sample_cosine_torch(prng.PRNGKey(1), chain, attrs.normal, lobe=True)
    bounce = functools.partial(frame.path_bounce_host, sc, d)
    with pytest.raises(ValueError, match="float32"):
        bounce(attrs, samples, illum.double())
    with pytest.raises(ValueError, match="float32"):
        bounce(attrs, (samples[0].half(), samples[1]))
    with pytest.raises(ValueError, match="shape"):
        bounce(attrs, (samples[0], samples[1][:-1]))
    with pytest.raises(ValueError, match="shape"):
        bounce(attrs._replace(uv=attrs.uv[..., :1]), samples)
    with pytest.raises(ValueError, match="int64"):
        bounce(attrs._replace(material=attrs.material.int()), samples)
    with pytest.raises(ValueError, match="bool"):
        bounce(attrs._replace(hit=attrs.hit.to(torch.uint8)), samples)
    with pytest.raises(ValueError, match="samples"):
        bounce(attrs)
    with pytest.raises(ValueError, match="filter"):
        bounce(attrs, samples, tex_filter="cubic")
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        frame.path_bounce_host(sc, d[..., :2], attrs, samples)
    state, _ = bounce(attrs, samples)
    with pytest.raises(ValueError, match="contiguous"):
        bounce(attrs, samples, None, (state[0].transpose(0, 1).contiguous().transpose(0, 1),
                                      *state[1:]))
    with pytest.raises(ValueError, match="shape"):
        bounce(attrs, samples, None, (state[0], state[1], state[2][:-1]))
    with pytest.raises(ValueError, match="float32"):
        frame.path_bounce_host(sc, d, traversal.cast_rays(sc, d * 0, d)._replace(
            t=torch.zeros(d.shape[:-1], dtype=torch.float64)), state=state, tail=True)
    with pytest.raises(ValueError, match="cuda"):
        frame.path_bounce_cuda(sc, d, attrs, samples)
