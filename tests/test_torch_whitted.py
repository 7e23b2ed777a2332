"""The port's lit shading, Whitted integrator, display mapping and demo
driver on the CPU, against the JAX package.

Shading modules take the same hit attributes (computed by the JAX
package, handed over as tensors) on both sides and must agree exactly;
their shadow casts are the JAX brute cast and the port's ``cuda`` cast,
which on CPU tensors runs the plain versions of K1 and K3. Whole images
are compared exactly with the goldens the JAX package rendered on the
CPU (tests/golden/*.npy), with ``backend="cuda"``. ``tonemap``'s gamma
is a ``pow`` whose last bit differs between PyTorch's and XLA's CPU
libraries, so its ``reinhard``/``aces`` outputs are held to rtol 1e-6.
"""

import functools
import os

import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
import tpu_raytracer.render.integrators as jint
import tpu_raytracer.render.shade as jshade
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.renderer import get_cast_fn as jax_cast_fn
from tpu_raytracer.render.renderer import hit_attributes as jax_hit_attributes
from tpu_raytracer_torch.app import scenes as port_scenes
from tpu_raytracer_torch.kernels import traversal
from tpu_raytracer_torch.render import RenderConfig, integrators, render_image
from tpu_raytracer_torch.render import render_image_whitted, shade
from tpu_raytracer_torch.render.renderer import HitAttributes, hit_attributes, occlusion_cast_fn
from tpu_raytracer_torch.render.sorted_cast import secondary_cast_fn
from tpu_raytracer_torch.scene.scene import from_scene_arrays
from tpu_raytracer_torch.utils import encode_png

from test_torch_scene import jax_fields

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
LIGHT = shade.DEFAULT_LIGHT_DIRECTION


@functools.lru_cache(maxsize=None)
def config4_attrs():
    """Config 4 at 32x32: the JAX scene, its primary rays and hit
    attributes, and the same as port tensors."""
    ja, cam = jscenes.scene_instances(32, 32)
    p = cam.ray_params()
    o, d = jax_generate_rays(32, 32, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    jattrs = jax_hit_attributes(ja, o, d, jax_cast_fn("brute")(ja, o, d))
    pattrs = HitAttributes(*(torch.from_numpy(np.array(a)) for a in jattrs))
    pattrs = pattrs._replace(material=pattrs.material.long(), inst=pattrs.inst.long())
    return ja, from_scene_arrays(jax_fields(ja), device="cpu"), d, jattrs, pattrs


# (0, 0, 1) normalises exactly in both packages; other lights do not:
# XLA's eager CPU rsqrt and PyTorch's round a unit vector to
# neighbouring floats, which moves a cosine by an ulp, so those are held
# to rtol 1e-6. Blinn-Phong's view vector is such a per-ray normalise,
# and its 32nd power spreads an ulp to ~10, so it is held to rtol 2e-6
# for every light. The low light is the one whose shadows show at this
# size (on config 4's floor).
LIGHTS = {"axis": (0.0, 0.0, 1.0), "default": LIGHT, "low": (-0.5, -0.5, 1.0)}


def assert_illum_equal(got, want, light, mode=""):
    if mode == "blinn_phong":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    elif light == "axis":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("light", sorted(LIGHTS))
@pytest.mark.parametrize("mode", ["flat", "lambert", "lambert_shadow", "blinn_phong"])
def test_compute_illumination_matches_jax(mode, light):
    ja, pa, d, jattrs, pattrs = config4_attrs()
    ldir = LIGHTS[light]
    want = np.asarray(jshade.compute_illumination(ja, jattrs, ldir, mode, backend="brute",
                                                  directions=d))
    got = shade.compute_illumination(pa, pattrs, ldir, mode, backend="cuda",
                                     directions=torch.from_numpy(np.array(d)))
    assert_illum_equal(got.numpy(), want, light, mode)
    if mode == "lambert_shadow" and light == "low":
        lit = shade.compute_illumination(pa, pattrs, ldir, "lambert")
        assert (got < lit).any()  # some hit points are in shadow


@pytest.mark.parametrize("light", sorted(LIGHTS))
@pytest.mark.parametrize("clamp_floor", [None, 0.4])
def test_direct_illumination_matches_jax(clamp_floor, light):
    ja, pa, _, jattrs, pattrs = config4_attrs()
    jcast = jax_cast_fn("brute")
    want = np.asarray(jint._direct_illumination(ja, jcast, jattrs, LIGHTS[light], (), True,
                                                True, clamp_floor=clamp_floor))
    got = integrators._direct_illumination(pa, traversal.cast_rays, pattrs, LIGHTS[light], (),
                                           True, True, occ_cast=occlusion_cast_fn("cuda"),
                                           clamp_floor=clamp_floor)
    assert_illum_equal(got.numpy(), want, light)


@pytest.mark.parametrize("mode", ["none", "reinhard", "aces"])
def test_tonemap_and_to_u8_match_jax(mode):
    radiance = np.random.default_rng(5).uniform(0.0, 3.0, (16, 16, 3)).astype(np.float32)
    want = np.asarray(jint.tonemap(radiance, mode, 1.3))
    got = integrators.tonemap(torch.from_numpy(radiance), mode, 1.3).numpy()
    if mode == "none":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(integrators.to_u8(torch.from_numpy(want.copy())).numpy(),
                                  np.asarray(jint.to_u8(want)))


def _render_config2():
    scene, cam = port_scenes.scene_cornell(64, device="cpu")
    return render_image, RenderConfig(64, 64, lighting="lambert_shadow"), scene, cam


def _render_config3():
    scene, cam = port_scenes.scene_bunny(96, 96, subdivisions=4, device="cpu")
    return render_image, RenderConfig(96, 96, lighting="blinn_phong"), scene, cam


def _render_config4():
    scene, cam = port_scenes.scene_instances(64, 64, device="cpu")
    return render_image_whitted, RenderConfig(64, 64), scene, cam


@pytest.mark.parametrize("golden,recipe", [
    ("config2_cornell_64", _render_config2),  # K3 + any-hit shadows
    ("config3_bunny_96", _render_config3),  # K1, Blinn-Phong
    ("config4_instances_whitted_64", _render_config4),  # K3, 3 bounces + shadows
])
def test_render_matches_cpu_golden(golden, recipe):
    fn, config, scene, cam = recipe()
    assert config.backend == "cuda"
    p = cam.ray_params(device="cpu")
    img = fn(config, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    assert img.dtype == torch.uint8
    np.testing.assert_array_equal(img.numpy(), np.load(os.path.join(GOLDEN_DIR, golden + ".npy")))


def test_driver_renders_the_demo(tmp_path, capsys, monkeypatch):
    """Two frames of the spinning demo at 64x64: the driver's frame is
    ``render`` of the port's demo scene after the same two spins, and the
    port renders the JAX package's spun demo scene as the JAX package's
    ``bvh`` backend does, but for 2 pixels. There two rays graze the
    cube's edge just outside its root box: the triangle test accepts hits
    up to EDGE_EPS outside an edge, the ``bvh`` walk never tests the root
    box of the cube (a 12-triangle leaf), and the 4-wide tables do (the
    JAX package's own wide TLAS kernel misses both rays too)."""
    from tpu_raytracer.app.driver import build_demo_scene as jax_demo
    from tpu_raytracer.render import Camera as JaxCamera
    from tpu_raytracer.render import RenderConfig as JaxConfig
    from tpu_raytracer.render import render_image as jax_render
    from tpu_raytracer.scene import MeshInstance as JaxMeshInstance
    from tpu_raytracer_torch.app import driver
    from tpu_raytracer_torch.app.driver import run
    from tpu_raytracer_torch.render import Camera, render
    from tpu_raytracer_torch.scene import MeshInstance
    from tpu_raytracer_torch.utils import overlay_fps

    fps = []  # the FPS the driver burns into out.png
    monkeypatch.setattr(driver, "overlay_fps", lambda im, f: fps.append(f) or overlay_fps(im, f))
    out = tmp_path / "demo.png"
    img = run("demo", 64, 64, frames=2, out=str(out), device="cpu")
    assert capsys.readouterr().out.count("FPS:") == 2
    assert out.read_bytes() == encode_png(overlay_fps(img.numpy(), fps[-1]))

    scene = port_scenes.build_demo_scene().compile(device="cpu")
    arrays = jax_demo().compile()
    for angle in (0.005, 0.010):
        pose = np.array([0, 0, 0, angle, 0, 0], np.float32)
        scene = scene.update_instance(0, MeshInstance(0, 2, pose=pose))
        spun = JaxMeshInstance(0, 2)
        spun.pose = pose
        arrays = arrays.update_instance(0, spun)
    cam = Camera.looking(64, 64, fov_deg=60.0, pose=[-1.0, -4.0, 2.0, 0, 0, 0])
    want = render(cam, scene)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    hit = (want.numpy() != np.array(shade.SKY_COLOR, np.uint8)).any(-1).mean()
    assert 0.05 < hit < 0.9

    jcam = JaxCamera.looking(64, 64, fov_deg=60.0)
    jcam.pose = cam.pose
    p = jcam.ray_params()
    jargs = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    jimg = np.asarray(jax_render(JaxConfig(64, 64, backend="bvh"), arrays, *jargs))
    got = render_image(RenderConfig(64, 64), from_scene_arrays(jax_fields(arrays), device="cpu"),
                       *(torch.from_numpy(np.array(a)) for a in jargs))
    assert (got.numpy() != jimg).any(-1).sum() <= 2


def test_unported_lighting_options_raise():
    # the lighting options are ported; what stays refused is refused by name
    _, pa, d, _, pattrs = config4_attrs()
    with pytest.raises(ValueError, match="nearest_cast_fn"):
        shade.compute_illumination(pa, pattrs, LIGHT, "lambert_shadow",
                                   point_lights=(integrators.PointLight((0, 0, 3)),),
                                   cast_fn=occlusion_cast_fn("cuda"))
    with pytest.raises(ValueError, match="normal_mode"):
        hit_attributes(pa, torch.zeros(3), torch.from_numpy(np.array(d)),
                       traversal.cast_rays(pa, torch.zeros(3), torch.from_numpy(np.array(d))),
                       normal_mode="transpose")
    with pytest.raises(ValueError, match="texture filter"):
        shade.surface_color(pa, pattrs, tex_filter="anisotropic")
    # the coherence sort serves the cuda backend only; others pass through
    assert secondary_cast_fn(traversal.cast_rays, "brute", sort_secondary=True) \
        is traversal.cast_rays
    from tpu_raytracer_torch.utils import prng

    with pytest.raises(ValueError, match="occlusion"):
        traversal.cast_rays_wide_torch(pa, torch.zeros(3), torch.from_numpy(np.array(d)),
                                       occlusion=True, carry_n=True)
    assert integrators.render_path_traced(
        pa, torch.zeros(3), torch.from_numpy(np.array(d)), prng.PRNGKey(0), max_bounces=1,
        samples=1, point_lights=(integrators.PointLight((0, 0, 3)),)).shape == d.shape
    from tpu_raytracer_torch.app.driver import run

    with pytest.raises(ValueError, match="mode"):
        run("cube", 16, 16, frames=1, device="cpu", mode="aov")
