"""Path tracing, AO and denoise (BASELINE config 5) of the port on the CPU,
against the JAX package.

  * ``utils/prng.py`` is ``jax.random``'s threefry bit for bit: keys,
    splits, fold-ins and uniform floats.
  * ``morton30`` and ``ray_sort_keys`` equal the JAX functions bit for
    bit, and the sorted cast gives the unsorted cast's hits.
  * ``_cosine_sample`` is within 1e-6 per component of JAX's (its sqrt,
    cos and sin round differently from XLA's in 0.6-5% of inputs, by one
    ulp; on unit vectors an absolute bound is the meaningful one).
  * ``render_path_traced`` and ``render_ao`` on the same scene, rays and
    key as the JAX package's, both casting with the brute-force oracle
    on the JAX side and the ``cuda`` backend's plain casts on the port's:
    equal radiance, except for pixels whose bounce or tail ray flips
    between two answers under such a direction (none at these sizes).
  * ``atrous_denoise`` at rtol 1e-5 (exp and the 3-term sums round
    differently).
  * The slice as a whole: ``config5_colonnade_path_64``, the JAX
    package's jitted ``bvh`` render, through the port's ``bvh`` (K2) and
    ``cuda`` (K1) backends: the two port images are equal, and they
    differ from the golden in at most ``GOLDEN5_MAX_MISMATCH`` pixels,
    with the mean within 1%.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
import tpu_raytracer.render.integrators as jint
import tpu_raytracer.render.sorted_cast as jsort
from tpu_raytracer.app.controls import fly_through as jax_fly_through
from tpu_raytracer.core.vecmath import normalize as jnormalize
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.denoise import atrous_denoise as jax_atrous
from tpu_raytracer_torch.app import scenes as port_scenes
from tpu_raytracer_torch.app.controls import fly_through
from tpu_raytracer_torch.core.vecmath import normalize
from tpu_raytracer_torch.kernels import binary, traversal
from tpu_raytracer_torch.render import (
    RenderConfig, hit_attributes, integrators, render_image_ao, render_image_path_traced,
    render_radiance_path_traced,
)
from tpu_raytracer_torch.render.denoise import atrous_denoise
from tpu_raytracer_torch.render.shade import DEFAULT_LIGHT_DIRECTION
from tpu_raytracer_torch.render.sorted_cast import (
    cast_rays_sorted, morton30, park_dead_rays, ray_sort_keys, secondary_cast_fn,
)
from tpu_raytracer_torch.scene.scene import from_scene_arrays
from tpu_raytracer_torch.utils import encode_png, prng

from test_torch_scene import jax_fields

torch.set_num_threads(1)

GOLDEN5 = os.path.join(os.path.dirname(__file__), "golden", "config5_colonnade_path_64.npy")
# config5_colonnade_path_64 against the port on the CPU: 9 of 4,096
# pixels differ (torch 2.13, both backends), each a bounce ray that a
# direction or hit point a few ulps off sends to another triangle; the
# golden comes from the jitted JAX package, whose XLA contracts FMAs and
# rounds sin, cos and sqrt its own way
GOLDEN5_MAX_MISMATCH = 16


def bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prng_is_jax_random_bit_for_bit(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk).astype(np.int64))
    for n in (1, 3, 5):
        np.testing.assert_array_equal(prng.split(pk, n).numpy(),
                                      np.asarray(jax.random.split(jk, n)).astype(np.int64))
    for data in (0, 1, 3):
        np.testing.assert_array_equal(prng.fold_in(pk, data).numpy(),
                                      np.asarray(jax.random.fold_in(jk, data)).astype(np.int64))
    sub = prng.split(pk, 3)[2]
    jsub = jax.random.split(jk, 3)[2]
    for shape in ((5,), (2, 64, 64), (2, 64, 64, 2)):
        for key, jkey in ((pk, jk), (sub, jsub)):
            np.testing.assert_array_equal(bits(prng.uniform(key, shape)),
                                          bits(jax.random.uniform(jkey, shape)))
            np.testing.assert_array_equal(
                bits(prng.uniform(key, shape, 0.0, 2.0 * math.pi)),
                bits(jax.random.uniform(jkey, shape, minval=0.0, maxval=2.0 * np.pi)))


@pytest.mark.parametrize("lo,hi", [(0.0, 2.0 * math.pi), (-1.5, 3.25), (0.1, 0.7)])
def test_uniform_bounds_keep_their_bits(lo, hi):
    """``uniform``'s bounds are made on the device by fill kernels (no
    copy from the host, so a frame can be captured): the same f32 bits
    as the host-made bounds gave, and ``jax.random.uniform``'s bits
    where ``minval`` is 0 (every draw of the port's). Past 0, XLA
    contracts ``floats * (hi - lo) + lo`` into one FMA, so JAX's last
    bits may differ there (within 1e-6)."""
    key = prng.split(prng.PRNGKey(11), 2)[1]
    got = prng.uniform(key, (3, 33), lo, hi)
    bits_ = (prng.random_bits(key, (3, 33)) >> 9) | 0x3F800000
    floats = bits_.to(torch.int32).view(torch.float32) - 1.0
    t_lo = torch.tensor(lo, dtype=torch.float32)
    t_hi = torch.tensor(hi, dtype=torch.float32)
    before = torch.maximum(t_lo, floats * (t_hi - t_lo) + t_lo)
    np.testing.assert_array_equal(bits(got), bits(before))
    jkey = jax.random.split(jax.random.PRNGKey(11), 2)[1]
    want = np.asarray(jax.random.uniform(jkey, (3, 33), minval=lo, maxval=hi))
    if lo == 0.0:
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("view", ["forward", "down"])
def test_lens_basis_keeps_its_bits_and_matches_jax(view):
    """The thin lens's axes, with the reference vector chosen on the
    device: the bits of the host-side choice it replaces, and JAX's
    ``jnp.where`` basis within 1e-6 (its sum rounds its own way). The
    two views take the two branches (+z, then +x as reference)."""
    rng = np.random.default_rng(4)
    d = rng.normal(0.0, 0.2, (8, 8, 3)).astype(np.float32)
    d[..., 1 if view == "forward" else 2] += -1.0 if view == "down" else 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pd = torch.from_numpy(d)
    right, up = integrators.lens_basis(pd)
    axis = normalize(pd.reshape(-1, 3).mean(dim=0))
    ref = torch.tensor([0.0, 0.0, 1.0] if abs(float(axis[2])) < 0.9 else [1.0, 0.0, 0.0])
    assert (abs(float(axis[2])) < 0.9) == (view == "forward")
    old_right = normalize(torch.linalg.cross(axis, ref))
    np.testing.assert_array_equal(bits(right), bits(old_right))
    np.testing.assert_array_equal(bits(up), bits(torch.linalg.cross(old_right, axis)))
    jaxis = jnormalize(jnp.mean(jnp.asarray(d).reshape(-1, 3), axis=0), exact=True)
    jref = jnp.where(jnp.abs(jaxis[2]) < 0.9, jnp.array([0.0, 0.0, 1.0], jnp.float32),
                     jnp.array([1.0, 0.0, 0.0], jnp.float32))
    jright = jnormalize(jnp.cross(jaxis, jref), exact=True)
    np.testing.assert_allclose(right.numpy(), np.asarray(jright), rtol=0, atol=1e-6)
    np.testing.assert_allclose(up.numpy(), np.asarray(jnp.cross(jright, jaxis)), rtol=0,
                               atol=1e-6)


def test_depth_of_field_matches_jax():
    """The thin-lens path (per-sample primary casts from the lens disk)
    on the same scene, rays and key as the JAX package's, with the
    flip bound of ``test_path_tracer_matches_jax``."""
    jscene, cam = jscenes.scene_colonnade(16, 16, columns=4, segs=8)
    (o, d), port, (po, pd) = _jax_and_port(jscene, cam)
    kw = dict(max_bounces=1, samples=2, lens_radius=0.1, focus_distance=3.0)
    want = np.asarray(jint.render_path_traced(jscene, o, d, jax.random.PRNGKey(3),
                                              backend="brute", **kw))
    got = integrators.render_path_traced(port, po, pd, prng.PRNGKey(3), backend="cuda",
                                         **kw).numpy()
    flips = int((~np.isclose(got, want, rtol=1e-5, atol=1e-6)).any(-1).sum())
    print(f"depth of field: {flips} flipped pixels of {got.shape[0] * got.shape[1]}")
    assert flips <= 0.01 * got.shape[0] * got.shape[1]
    assert (got != integrators.render_path_traced(port, po, pd, prng.PRNGKey(3),
                                                  backend="cuda", max_bounces=1,
                                                  samples=2).numpy()).any()


def _rays_np(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def test_morton_and_sort_keys_match_jax():
    q = np.random.default_rng(2).integers(0, 1024, (1000, 3)).astype(np.int32)
    np.testing.assert_array_equal(morton30(torch.from_numpy(q)).numpy(),
                                  np.asarray(jsort.morton30(jnp.asarray(q))))
    o, d = _rays_np()
    np.testing.assert_array_equal(ray_sort_keys(torch.from_numpy(o), torch.from_numpy(d)).numpy(),
                                  np.asarray(jsort.ray_sort_keys(jnp.asarray(o), jnp.asarray(d))))
    # a bounce batch holds parked rays; their origin sets the bounds of
    # the quantisation in both packages, so every live ray's Morton code
    # is 0 and the key is the direction octant alone
    live = np.random.default_rng(4).uniform(size=o.shape[0]) < 0.7
    po, pd = park_dead_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(live))
    keys = ray_sort_keys(po, pd)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jsort.ray_sort_keys(
        jnp.asarray(po.numpy()), jnp.asarray(pd.numpy()))))
    distinct = int(torch.unique(keys[torch.from_numpy(live)]).numel())
    print(f"ray_sort_keys: {distinct} distinct keys among {int(live.sum())} live rays")
    assert distinct <= 8


def _bounce_rays(scene, cam, seed=1):
    """Cosine-sampled bounce rays [2, H, W, 3] off the primary hits, dead
    rays parked: the path tracer's first bounce cast."""
    p = cam.ray_params("cpu")
    from tpu_raytracer_torch.render import generate_rays

    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    attrs = hit_attributes(scene, o, d, traversal.cast_rays(scene, o, d))
    normal = attrs.normal[None].expand((2,) + attrs.normal.shape)
    nd = integrators._cosine_sample(prng.PRNGKey(seed), normal, True)
    no = attrs.location[None] + nd * 1e-4
    return park_dead_rays(no, nd, attrs.hit[None].expand(nd.shape[:-1]))


def test_sorted_cast_equals_unsorted_cast():
    scene, cam = port_scenes.scene_colonnade(32, 32, columns=4, segs=8, device="cpu")
    o, d = _bounce_rays(scene, cam)
    want = traversal.cast_rays(scene, o, d)
    assert (want.tri >= 0).any() and (want.tri < 0).any()
    cast = secondary_cast_fn(traversal.cast_rays, "cuda", sort_secondary=True)
    assert cast is not traversal.cast_rays
    for got in (cast(scene, o, d), cast_rays_sorted(traversal.cast_rays, scene, o, d)):
        for a, b in zip(got[:3], want[:3]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    occ = cast(scene, o, d, occlusion=True)
    assert torch.equal(occ.t < 0, want.t < 3.0e38)
    assert secondary_cast_fn(binary.cast_rays_binary_cuda, "bvh", True) \
        is binary.cast_rays_binary_cuda


def test_path_frame_casts_bounces_in_wavefront_order(monkeypatch):
    """On the cuda backend ``render_path_traced`` casts its bounce rays and
    its any-hit tail unsorted by default: ``cast_rays_sorted`` is never
    called, and the radiance is bitwise the sorted frame's, which goes
    through it for both casts."""
    from tpu_raytracer_torch.render import generate_rays, sorted_cast

    scene, cam = port_scenes.scene_colonnade(32, 32, columns=4, segs=8, device="cpu")
    p = cam.ray_params("cpu")
    o, d = generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    frame = lambda **kw: integrators.render_path_traced(scene, o, d, prng.PRNGKey(3), 2, 2,
                                                        backend="cuda", **kw)
    real, calls = sorted_cast.cast_rays_sorted, []

    def counted(*args, **kw):
        calls.append(getattr(args[0], "keywords", {}).get("occlusion", False))
        return real(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(sorted_cast, "cast_rays_sorted", counted)
        want = frame(sort_secondary=True)
    assert calls == [False, True]  # the bounce cast, then the any-hit tail

    def refuse(*args, **kw):
        raise AssertionError("the default path frame sorted a cast")

    monkeypatch.setattr(sorted_cast, "cast_rays_sorted", refuse)
    with pytest.raises(AssertionError, match="sorted a cast"):
        frame(sort_secondary=True)
    got = frame()
    assert (got > 0).any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cosine_sample_matches_jax():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0, 0, :4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]  # the basis's branches
    want = np.asarray(jint._cosine_sample(jax.random.PRNGKey(5), jnp.asarray(n), True))
    got = integrators._cosine_sample(prng.PRNGKey(5), torch.from_numpy(n), True).numpy()
    err = float(np.abs(got - want).max())
    print(f"_cosine_sample: max abs difference {err:.3g}, bitwise equal "
          f"{(bits(got) == bits(want)).mean():.3f}")
    assert err <= 1e-6  # 1.8e-7 measured
    np.testing.assert_allclose((got * n).sum(-1) > 0, True)  # the upper hemisphere


def _jax_and_port(jscene, cam):
    p = cam.ray_params()
    o, d = jax_generate_rays(cam.width, cam.height, p["K_inv"], p["D"], p["pose"],
                             p["inv_pose"])
    port = from_scene_arrays(jax_fields(jscene), device="cpu")
    return (o, d), port, (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)))


@pytest.mark.parametrize("case", ["colonnade_tail", "cornell_mirror_nee"])
def test_path_tracer_matches_jax(case):
    """One bounce, two samples, the same key. The colonnade takes the
    sample-batched wavefront with the any-hit tail; the mirror Cornell box
    adds the glossy lobe and next-event estimation toward the sun."""
    if case == "colonnade_tail":
        jscene, cam = jscenes.scene_colonnade(16, 16, columns=4, segs=8)
        kw = {}
    else:
        jscene, cam = jscenes.scene_cornell(16, mirror=True)
        kw = {"light_direction": DEFAULT_LIGHT_DIRECTION}
    (o, d), port, (po, pd) = _jax_and_port(jscene, cam)
    want = np.asarray(jint.render_path_traced(jscene, o, d, jax.random.PRNGKey(3),
                                              max_bounces=1, samples=2, backend="brute", **kw))
    got = integrators.render_path_traced(port, po, pd, prng.PRNGKey(3), max_bounces=1,
                                         samples=2, backend="cuda", **kw).numpy()
    # a flip: a bounce ray that another triangle (or the sky) answers;
    # elsewhere the mirror Cornell box differs by ulps (the sun's and the
    # glossy lobe's normalize is an rsqrt, which rounds differently)
    flips = int((~np.isclose(got, want, rtol=1e-5, atol=1e-6)).any(-1).sum())
    differ = int((got != want).any(-1).sum())
    print(f"{case}: {flips} flipped and {differ} differing pixels of "
          f"{got.shape[0] * got.shape[1]}")
    assert flips <= 0.01 * got.shape[0] * got.shape[1]  # 0 measured
    if case == "colonnade_tail":
        assert differ == 0  # 0 measured
    if case == "cornell_mirror_nee":
        assert (port.mat_reflectivity > 0).any()


def test_ao_matches_jax():
    jscene, cam = jscenes.scene_cornell(16)
    (o, d), port, (po, pd) = _jax_and_port(jscene, cam)
    want = np.asarray(jint.render_ao(jscene, o, d, jax.random.PRNGKey(4), samples=4,
                                     backend="brute"))
    got = integrators.render_ao(port, po, pd, prng.PRNGKey(4), samples=4, backend="cuda").numpy()
    off = got != want
    print(f"AO: {int(off.sum())} of {off.size} pixels differ from JAX")  # 0 measured
    np.testing.assert_allclose(np.abs(got - want)[off], 0.25)  # one sample flipped
    assert off.mean() <= 0.02
    assert 0.0 < got.mean() < 1.0 and (got < 1.0).any()


@pytest.mark.parametrize("backend", ["cuda", "bvh"])
@pytest.mark.parametrize("which", ["tiny_colonnade", "cornell"])
def test_ao_bounded_sample_casts_match_unbounded(which, backend, monkeypatch):
    """``render_ao`` asks for its sample casts bounded by the radius and
    its primary cast unbounded; the frame equals, pixel for pixel, the
    frame whose sample casts are unbounded. The tiny colonnade is one
    instance (K1's plain walk on ``cuda``), the Cornell box six (K3 on
    ``cuda``, which ignores the bound; K2's plain walk on ``bvh``)."""
    from tpu_raytracer_torch.render import generate_rays

    from test_torch_cast import tiny_colonnade

    if which == "cornell":
        scene, cam = port_scenes.scene_cornell(16, device="cpu")
        p = cam.ray_params("cpu")
        o, d = generate_rays(16, 16, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    else:
        scene, o, d = tiny_colonnade()
    real = integrators.get_cast_fn
    asked = []

    def spy(backend, want_normals=False, t_max=None):
        asked.append(t_max)
        return real(backend, want_normals, t_max)

    ao = lambda: integrators.render_ao(scene, o, d, prng.PRNGKey(4), samples=4, radius=1.0,
                                       backend=backend)
    monkeypatch.setattr(integrators, "get_cast_fn", spy)
    bounded = ao()
    assert asked == [None, 1.0]
    monkeypatch.setattr(integrators, "get_cast_fn",
                        lambda backend, want_normals=False, t_max=None: real(backend,
                                                                             want_normals))
    assert torch.equal(bounded, ao())
    assert 0.0 < float(bounded.mean()) < 1.0 and (bounded < 1.0).any()


def test_atrous_denoise_matches_jax():
    rng = np.random.default_rng(9)
    radiance = rng.uniform(0.0, 2.0, (32, 32, 3)).astype(np.float32)
    # two planes meeting at column 16, a little noise on the guides
    normal = np.zeros((32, 32, 3), np.float32)
    normal[:, :16, 2] = 1.0
    normal[:, 16:, 0] = 1.0
    normal += rng.normal(0.0, 0.05, normal.shape).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (3.0 + 0.02 * np.arange(32)[None, :] + rng.normal(0.0, 0.01, (32, 32)))
    depth = depth.astype(np.float32)
    depth[:4, :4] = np.inf  # misses
    want = np.asarray(jax_atrous(radiance, normal, depth, iterations=3))
    got = atrous_denoise(torch.from_numpy(radiance), torch.from_numpy(normal),
                         torch.from_numpy(depth), iterations=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.abs(got - radiance).mean() > 0.01  # it smooths (0.031 measured)
    assert atrous_denoise(torch.from_numpy(radiance), torch.from_numpy(normal),
                          torch.from_numpy(depth), iterations=0).numpy() is not None


def test_fly_through_matches_jax():
    start = np.array([1.0, -2.0, 1.6, 0.0, 0.0, 0.0], np.float32)
    want = list(jax_fly_through(start, frames=5, forward_per_frame=0.15))
    got = list(fly_through(start, frames=5, forward_per_frame=0.15))
    np.testing.assert_allclose(np.stack(got), np.stack([np.asarray(w) for w in want]),
                               rtol=0, atol=1e-6)


def test_config5_golden_through_bvh_and_cuda():
    scene, cam = port_scenes.scene_colonnade(64, 64, columns=4, segs=8, device="cpu")
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    golden = np.load(GOLDEN5)
    images = {}
    for backend in ("bvh", "cuda"):
        images[backend] = render_image_path_traced(
            RenderConfig(64, 64, backend=backend), scene, *args, prng.PRNGKey(7), 2, 2).numpy()
    np.testing.assert_array_equal(images["bvh"], images["cuda"])
    img = images["bvh"]
    mismatch = int((img != golden).any(-1).sum())
    print(f"config5_colonnade_path_64: {mismatch} pixels differ from the golden")
    assert mismatch <= GOLDEN5_MAX_MISMATCH
    assert abs(img.astype(np.float64).mean() / golden.mean() - 1.0) < 0.01
    # the sorted bounce casts give the unsorted image (the cuda default)
    sorted_ = render_image_path_traced(RenderConfig(64, 64), scene, *args, prng.PRNGKey(7), 2,
                                       2, sort_secondary=True).numpy()
    np.testing.assert_array_equal(sorted_, images["cuda"])
    # the any-hit tail answers the last bounce's hit-or-miss as the
    # nearest cast does (no emissive material here)
    nearest_tail = render_image_path_traced(RenderConfig(64, 64, backend="bvh"), scene, *args,
                                            prng.PRNGKey(7), 2, 2, fast_tail=False).numpy()
    np.testing.assert_array_equal(nearest_tail, images["bvh"])
    # the per-sample loop is another random stream of the same estimator
    loop = render_radiance_path_traced(RenderConfig(64, 64), scene, *args, prng.PRNGKey(7), 2, 2,
                                       sample_batch=False)
    assert abs(float(loop.mean()) * 255.0 / golden.mean() - 1.0) < 0.05


def test_denoise_and_dof_entry_points():
    scene, cam = port_scenes.scene_colonnade(32, 32, columns=4, segs=8, device="cpu")
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"], prng.PRNGKey(1), 2, 2)
    plain = render_image_path_traced(RenderConfig(32, 32, backend="bvh"), scene, *args)
    den = render_image_path_traced(RenderConfig(32, 32, backend="bvh", denoise=2), scene, *args)
    dof = render_image_path_traced(RenderConfig(32, 32, backend="bvh"), scene, *args,
                                   lens_radius=0.1, focus_distance=3.0)
    lit = render_image_path_traced(RenderConfig(32, 32, backend="bvh", path_lights=True),
                                   scene, *args)
    for img in (den, dof, lit):
        assert img.shape == plain.shape and img.dtype == torch.uint8
        assert (img != plain).any()
    assert lit.float().mean() > plain.float().mean()  # the sun adds light
    ao = render_image_ao(RenderConfig(32, 32, backend="bvh"), scene, *args[:5], samples=4)
    assert ao.shape == (32, 32, 3) and (ao[..., 0] == ao[..., 2]).all()


@pytest.mark.parametrize("mode,scene_name", [("path", "cornell"), ("ao", "cornell")])
def test_driver_path_and_ao_modes(mode, scene_name, tmp_path, capsys, monkeypatch):
    from tpu_raytracer_torch.app import driver
    from tpu_raytracer_torch.app.driver import run
    from tpu_raytracer_torch.utils import overlay_fps

    fps = []  # the FPS the driver burns into out.png
    monkeypatch.setattr(driver, "overlay_fps", lambda im, f: fps.append(f) or overlay_fps(im, f))
    out = tmp_path / f"{mode}.png"
    kw = {"fly": True, "denoise": 1} if mode == "path" else {"ao_radius": 0.5}
    img = run(scene_name, 32, 32, frames=2, out=str(out), device="cpu", mode=mode,
              backend="bvh", **kw)
    assert capsys.readouterr().out.count("FPS:") == 2
    assert out.read_bytes() == encode_png(overlay_fps(img.numpy(), fps[-1]))
    assert tuple(img.shape) == (32, 32, 3) and img.float().std() > 0
