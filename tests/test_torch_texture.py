"""Texture filters, the sky map, the AOV pass, SSAA and the driver's
shading flags of the port on the CPU, against the JAX package.

Samplers take the same inputs (scenes compiled by both packages, the JAX
package's hit attributes handed over as tensors). Tolerances:
  * the compiled atlas, mip starts and sky fields, the procedural
    textures, ``uv_screen_derivatives`` and the AOV id buffers: bit for
    bit;
  * bilinear and trilinear samples and surface colours: rtol 1e-6, atol
    1e-6 (``log2`` rounds to neighbouring floats in XLA's and PyTorch's
    CPU libraries, which moves a filter weight by ulps);
  * sky radiance: atol ``SKY_ATOL`` = 1e-5: ``atan2`` and ``asin`` round
    apart by an ulp, and an ulp of v across the sky map's 190-level step
    at the horizon moves the bilinear sample by up to 6e-6 (3.2e-6 seen);
  * the AOV buffers: depth and normal at rtol 1e-6, atol 1e-6; uv at atol
    ``UV_ATOL`` = 1e-5: the posed cube's euler angles go through sin and
    cos, which round apart by an ulp, and at grazing hits the object
    ray's ulps move uv by up to 4.2e-6;
  * u8 frames: at most ``FRAME_MAX_PIXELS`` pixels apart, each one step
    (a shaded value within an ulp of a u8 step truncates to neighbouring
    bytes; an SSAA block average within an ulp of a half rounds so); the
    AO frame's differing pixels are one cosine sample flipped (16 levels
    after the 2x2 average), as ``test_torch_path.py`` allows.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

import tpu_raytracer.app.driver as jdriver
import tpu_raytracer.render.shade as jshade
import tpu_raytracer.scene as js
from tpu_raytracer.render import Camera as JaxCamera
from tpu_raytracer.render import RenderConfig as JaxConfig
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.pipeline import render_aovs as jax_render_aovs
from tpu_raytracer.render.pipeline import render_image as jax_render
from tpu_raytracer.render.pipeline import render_image_ao as jax_render_ao
from tpu_raytracer.render.renderer import get_cast_fn as jax_cast_fn
from tpu_raytracer.render.renderer import hit_attributes as jax_hit_attributes
from tpu_raytracer_torch import scene as ts
from tpu_raytracer_torch.app import driver
from tpu_raytracer_torch.app.scenes import build_demo_scene
from tpu_raytracer_torch.render import (
    Camera, RenderConfig, render_aovs, render_image, render_image_ao, render_image_whitted,
    shade,
)
from tpu_raytracer_torch.render.renderer import HitAttributes
from tpu_raytracer_torch.utils import prng

torch.set_num_threads(1)

FRAME_MAX_PIXELS = 4
SKY_ATOL = 1e-5
UV_ATOL = 1e-5
SIZE = 32


def textured_scene(S, sky: bool):
    """The reference app's demo scene (textured cube and board) plus a
    gradient-textured cube of odd size (its mip chain halves unevenly),
    with the procedural sky map where ``sky``."""
    scene = (jdriver.build_demo_scene() if S is js else build_demo_scene())
    grad = S.Material()
    grad.set_texture(S.procgen.gradient_texture(37, 23))
    scene.add_material(grad)
    scene.add_mesh(S.objloader.loads(S.procgen.cube_obj(0.5)))
    inst = S.MeshInstance(2, 4)
    inst.pose = np.array([0.6, -1.2, 0.9, 0.3, 0.2, 0.0], np.float32)
    scene.add_mesh_instance(inst)
    if sky:
        scene.set_sky(S.procgen.sky_gradient_texture())
    return scene


@functools.lru_cache(maxsize=None)
def scenes(sky: bool = True):
    """(JAX arrays, port scene, camera params, JAX attrs, port attrs)."""
    ja = textured_scene(js, sky).compile()
    pa = textured_scene(ts, sky).compile(device="cpu")
    cam = JaxCamera.looking(SIZE, SIZE, fov_deg=60.0, pose=[-1.0, -4.0, 2.0, 0, 0, 0])
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    o, d = jax_generate_rays(SIZE, SIZE, *args)
    jattrs = jax_hit_attributes(ja, o, d, jax_cast_fn("brute")(ja, o, d))
    pattrs = HitAttributes(*(torch.from_numpy(np.array(a)) for a in jattrs))
    pattrs = pattrs._replace(material=pattrs.material.long(), inst=pattrs.inst.long())
    return ja, pa, args, d, jattrs, pattrs


def port_args(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def frames_agree(got, want, bound=FRAME_MAX_PIXELS, max_step=1):
    got, want = np.asarray(got), np.asarray(want)
    off = (got != want).any(-1)
    step = np.abs(got.astype(int) - want.astype(int)).max()
    print(f"{int(off.sum())} of {off.size} pixels differ, by at most {step}")
    assert off.sum() <= bound
    assert step <= max_step or off.sum() == 0


def test_compiled_textures_and_sky_match_jax():
    ja, pa, *_ = scenes()
    for name in ("tex_atlas", "mat_tex_start", "mat_tex_w", "mat_tex_h", "mat_tex_mip_start",
                 "sky_tex_start", "sky_tex_w", "sky_tex_h"):
        np.testing.assert_array_equal(getattr(pa, name).numpy(), np.asarray(getattr(ja, name)),
                                      err_msg=name)
    assert pa.has_sky and int(pa.sky_tex_start) > 0
    assert pa.mat_tex_mip_start.shape[1] > 1
    for fn, a in ((ts.procgen.gradient_texture, (37, 23)), (ts.procgen.sky_gradient_texture, ())):
        np.testing.assert_array_equal(fn(*a), getattr(js.procgen, fn.__name__)(*a))
    with pytest.raises(ValueError, match="sky"):
        ts.Scene().set_sky(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_texture_samples_match_jax(filt):
    ja, pa, *_ = scenes()
    rng = np.random.default_rng(5)
    uv = rng.uniform(-1.5, 2.5, (257, 2)).astype(np.float32)
    for m in range(pa.mat_tex_start.shape[0]):
        if int(pa.mat_tex_start[m]) < 0:
            continue
        full = lambda x: np.full(uv.shape[0], int(x), np.int32)
        jargs = [full(getattr(ja, k)[m]) for k in ("mat_tex_start", "mat_tex_w", "mat_tex_h")]
        want = jshade._sample_texture_vals(ja, *jargs, uv, tex_filter=filt)
        got = shade._sample_texture_vals(pa, *(torch.from_numpy(a) for a in jargs),
                                         torch.from_numpy(uv), tex_filter=filt)
        close(got, want)


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_sample_texture_by_material_matches_jax(filt):
    ja, pa, *_ = scenes()
    rng = np.random.default_rng(8)
    uv = rng.uniform(-1.5, 2.5, (257, 2)).astype(np.float32)
    textured = np.nonzero(pa.mat_tex_start.numpy() >= 0)[0].astype(np.int32)
    assert textured.size >= 1
    material = rng.choice(textured, uv.shape[0]).astype(np.int32)
    want = jshade.sample_texture(ja, material, uv, tex_filter=filt)
    got = shade.sample_texture(pa, torch.from_numpy(material), torch.from_numpy(uv), filt)
    close(got, want)


def test_uv_screen_derivatives_match_jax():
    _, _, _, _, jattrs, pattrs = scenes()
    want = jshade.uv_screen_derivatives(jattrs)
    got = shade.uv_screen_derivatives(pattrs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] != 0).any() and (got[1] != 0).any()


def test_trilinear_sample_matches_jax():
    ja, pa, _, _, jattrs, pattrs = scenes()
    jd = jshade.uv_screen_derivatives(jattrs)
    pd = shade.uv_screen_derivatives(pattrs)
    # a steeper footprint too, so that the LOD climbs the mip chain
    for scale in (1.0, 9.0):
        want = jshade._sample_texture_trilinear(ja, jattrs.material, jattrs.uv,
                                                jd[0] * scale, jd[1] * scale)
        got = shade._sample_texture_trilinear(pa, pattrs.material, pattrs.uv,
                                              pd[0] * scale, pd[1] * scale)
        close(got, want)


@pytest.mark.parametrize("filt", ["nearest", "bilinear", "trilinear"])
def test_surface_color_matches_jax(filt):
    ja, pa, _, _, jattrs, pattrs = scenes()
    jd = jshade.uv_screen_derivatives(jattrs) if filt == "trilinear" else (None, None)
    pd = shade.uv_screen_derivatives(pattrs) if filt == "trilinear" else (None, None)
    want = jshade.surface_color(ja, jattrs, tex_filter=filt, uv_ddx=jd[0], uv_ddy=jd[1])
    got = shade.surface_color(pa, pattrs, filt, pd[0], pd[1])
    close(got, want)
    # trilinear without derivatives (a secondary ray) samples bilinear
    if filt == "trilinear":
        close(shade.surface_color(pa, pattrs, "trilinear"),
              shade.surface_color(pa, pattrs, "bilinear"))


def test_sky_radiance_matches_jax():
    ja, pa, *_ = scenes()
    rng = np.random.default_rng(6)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:8] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [1, 0, 0], [0, -1, 0], [-1, 0, 0],
             [0, 0, 2], [0.001, 0, -1]]
    want = jshade.sky_radiance(ja, d)
    got = shade.sky_radiance(pa, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SKY_ATOL)
    print(f"sky: {int((got.numpy() != np.asarray(want)).any(-1).sum())} of 4096 differ")
    assert got.std(0).min() > 0.01  # not the flat colour
    flat_j, flat_p = scenes(sky=False)[:2]
    np.testing.assert_array_equal(shade.sky_radiance(flat_p, torch.from_numpy(d)).numpy(),
                                  np.asarray(jshade.sky_radiance(flat_j, d)))


@pytest.mark.parametrize("filt,lighting", [("trilinear", "flat"), ("bilinear", "lambert")])
def test_sky_and_filtered_frame_matches_jax(filt, lighting):
    ja, pa, args, *_ = scenes()
    want = jax_render(JaxConfig(SIZE, SIZE, backend="bvh", texture_filter=filt,
                                lighting=lighting), ja, *args)
    got = render_image(RenderConfig(SIZE, SIZE, texture_filter=filt, lighting=lighting), pa,
                       *port_args(args))
    frames_agree(got.numpy(), want)
    sky = (got.numpy() != np.array(shade.SKY_COLOR, np.uint8)).any(-1)
    assert sky.all()  # the sky map, not the flat colour, on the misses


def test_render_aovs_match_jax():
    ja, pa, args, *_ = scenes()
    want = jax_render_aovs(JaxConfig(SIZE, SIZE, backend="bvh"), ja, *args)
    got = render_aovs(RenderConfig(SIZE, SIZE), pa, *port_args(args))
    assert set(got) == set(want)
    for k in ("instance", "triangle", "hit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("depth", "normal"):
        close(got[k], want[k])
    np.testing.assert_allclose(got["uv"].numpy(), np.asarray(want["uv"]), rtol=0, atol=UV_ATOL)
    assert got["hit"].any() and not got["hit"].all()
    assert got["instance"].dtype == torch.int32


@pytest.mark.parametrize("which", ["primary", "ao"])
def test_ssaa_matches_jax(which):
    ja, pa, args, *_ = scenes(sky=False)
    half = SIZE // 2
    # the camera's K_inv at half the size: ssaa=2 renders SIZE x SIZE subpixels
    cam = JaxCamera.looking(half, half, fov_deg=60.0, pose=[-1.0, -4.0, 2.0, 0, 0, 0])
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    if which == "primary":
        # bilinear: a nearest-texel flip at a checker edge would hide the
        # averaging under a 200-level step
        want = jax_render(JaxConfig(half, half, backend="bvh", lighting="lambert", ssaa=2,
                                    texture_filter="bilinear"), ja, *args)
        got = render_image(RenderConfig(half, half, lighting="lambert", ssaa=2,
                                        texture_filter="bilinear"), pa, *port_args(args))
    else:
        want = jax_render_ao(JaxConfig(half, half, backend="bvh", ssaa=2), ja, *args,
                             jax.random.PRNGKey(2), 4, 1.0)
        got = render_image_ao(RenderConfig(half, half, ssaa=2), pa, *port_args(args),
                              prng.PRNGKey(2), 4, 1.0)
    assert got.shape == (half, half, 3)
    frames_agree(got.numpy(), want, max_step=1 if which == "primary" else 16)


def test_ssaa_whitted_averages_the_supersampled_frame():
    _, pa, args, *_ = scenes(sky=False)
    half = SIZE // 2
    cam = Camera.looking(half, half, fov_deg=60.0, pose=[-1.0, -4.0, 2.0, 0, 0, 0])
    p = cam.ray_params("cpu")
    big = render_image_whitted(RenderConfig(SIZE, SIZE), pa, p["K_inv"] * torch.tensor(
        [0.5, 0.5, 1.0]), p["D"], p["pose"], p["inv_pose"])
    want = torch.round(big.float().reshape(half, 2, half, 2, 3).mean((1, 3))).to(torch.uint8)
    got = render_image_whitted(RenderConfig(half, half, ssaa=2), pa, p["K_inv"], p["D"],
                               p["pose"], p["inv_pose"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_aov_to_u8_matches_jax():
    rng = np.random.default_rng(7)
    bufs = {"depth": np.where(rng.random((8, 8)) < 0.2, np.inf, rng.random((8, 8)) * 9),
            "normal": rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32),
            "uv": rng.uniform(-0.5, 1.5, (8, 8, 2)).astype(np.float32),
            "instance": rng.integers(-1, 5, (8, 8)).astype(np.int32),
            "triangle": rng.integers(-1, 5000, (8, 8)).astype(np.int32),
            "hit": rng.random((8, 8)) < 0.5}
    for name, a in bufs.items():
        np.testing.assert_array_equal(driver._aov_to_u8(name, a), jdriver._aov_to_u8(name, a),
                                      err_msg=name)


def test_driver_shading_flags(tmp_path, capsys, monkeypatch):
    """The JAX driver's flags: the demo with the sky map, trilinear
    filtering, a point light without the sun, the inverse-transpose
    normal, the reference calibration, SSAA and every AOV."""
    out = str(tmp_path / "demo.png")
    monkeypatch.setattr("sys.argv", [
        "driver", "--device", "cpu", "--width", "16", "--height", "16", "--frames", "1",
        "--no-animate", "--out", out, "--sky", "gradient", "--texture-filter", "trilinear",
        "--lighting", "lambert", "--point-light", "0,-2,3,6", "--no-sun", "--normal-mode",
        "inverse_transpose", "--calib", "--ssaa", "2",
        *sum((["--aov", a] for a in driver.AOVS), [])])
    driver.main()
    printed = capsys.readouterr().out
    assert "FPS:" in printed
    for name in driver.AOVS:
        assert os.path.getsize(str(tmp_path / f"demo.{name}.png")) > 0
        assert f"AOV {name}" in printed
    # the frame is the pipeline's under the same options
    scene = build_demo_scene()
    scene.set_sky(ts.procgen.sky_gradient_texture())
    scene = scene.compile(device="cpu")
    K, D = driver.reference_calibration(16, 16)
    cam = Camera(16, 16, K, D, pose=np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32))
    cfg = RenderConfig(16, 16, lighting="lambert", light_direction=None,
                       point_lights=(driver.PointLight((0.0, -2.0, 3.0), 6.0),),
                       texture_filter="trilinear", ssaa=2, normal_mode="inverse_transpose")
    p = cam.ray_params("cpu")
    want = render_image(cfg, scene, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    got = driver.run("demo", 16, 16, frames=1, out=str(tmp_path / "again.png"), device="cpu",
                     animate=False, lighting="lambert", point_lights=((0, -2, 3, 6),),
                     no_sun=True, texture_filter="trilinear", ssaa=2, sky="gradient",
                     calib=True, normal_mode="inverse_transpose")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
