"""Point lights, the inverse-transpose normal and vertex normals of the
port on the CPU, against the JAX package.

Shading functions take the same hit attributes (the JAX package's,
handed over as tensors) on both sides; their shadow casts, and the
casts of whole frames, are the JAX brute cast and the port's ``cuda``
cast, which on CPU tensors runs the plain versions of K1 and K3 (equal
to the brute cast in t). Tolerances:
  * point-light terms, illumination and hit attributes: rtol 1e-6 (the
    sqrt, rsqrt and division of a light's distance and direction round
    to neighbouring floats in XLA's and PyTorch's CPU libraries), 2e-6
    for Blinn-Phong (its 32nd power spreads an ulp, as
    ``test_torch_whitted.py`` says), atol 1e-6 where a value can be 0;
  * the compiled ``tri_vnorm`` and the parsed vertex normals: bit for bit;
  * u8 frames: at most ``FRAME_MAX_PIXELS`` pixels apart, each where a
    shaded value lies within an ulp of a u8 step (the truncating cast
    then rounds the two sides to neighbouring bytes).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import tpu_raytracer.app.scenes as jscenes
import tpu_raytracer.render.integrators as jint
import tpu_raytracer.render.shade as jshade
import tpu_raytracer.scene as js
from tpu_raytracer.render import Camera as JaxCamera
from tpu_raytracer.render import RenderConfig as JaxConfig
from tpu_raytracer.render import generate_rays as jax_generate_rays
from tpu_raytracer.render.pipeline import render_image as jax_render
from tpu_raytracer.render.pipeline import render_image_path_traced as jax_render_path
from tpu_raytracer.render.pipeline import render_image_whitted as jax_whitted
from tpu_raytracer.render.renderer import get_cast_fn as jax_cast_fn
from tpu_raytracer.render.renderer import hit_attributes as jax_hit_attributes
from tpu_raytracer_torch import scene as ts
from tpu_raytracer_torch.kernels import traversal
from tpu_raytracer_torch.render import (
    RenderConfig, hit_attributes, integrators, render_image, render_image_path_traced,
    render_image_whitted, shade,
)
from tpu_raytracer_torch.render.renderer import HitAttributes, occlusion_cast_fn
from tpu_raytracer_torch.scene.scene import from_scene_arrays
from tpu_raytracer_torch.utils import prng

from test_torch_scene import compiled, jax_fields, jax_rays

torch.set_num_threads(1)

LIGHT = shade.DEFAULT_LIGHT_DIRECTION
# config 4's floor sits at z = -1.2; these lights hang over it, the second
# low enough that the instances cast point shadows on the floor
POINT_LIGHTS = ((0.0, 2.0, 2.0, 4.0), (1.5, 1.0, 0.2, 2.0))
FRAME_MAX_PIXELS = 4


def jax_lights(specs=POINT_LIGHTS):
    return tuple(jint.PointLight(position=s[:3], intensity=s[3]) for s in specs)


def port_lights(specs=POINT_LIGHTS):
    return tuple(integrators.PointLight(position=s[:3], intensity=s[3]) for s in specs)


@functools.lru_cache(maxsize=None)
def config4(size=32):
    """Config 4: the JAX scene, its camera, primary rays and hit
    attributes, and the same as port tensors."""
    ja, cam = jscenes.scene_instances(size, size)
    p = cam.ray_params()
    o, d = jax_generate_rays(size, size, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    jattrs = jax_hit_attributes(ja, o, d, jax_cast_fn("brute")(ja, o, d))
    pattrs = HitAttributes(*(torch.from_numpy(np.array(a)) for a in jattrs))
    pattrs = pattrs._replace(material=pattrs.material.long(), inst=pattrs.inst.long())
    return ja, cam, from_scene_arrays(jax_fields(ja), device="cpu"), d, jattrs, pattrs


@pytest.mark.parametrize("shadowed", [False, True])
def test_point_light_illumination_matches_jax(shadowed):
    ja, _, pa, _, jattrs, pattrs = config4()
    jcast = jax_cast_fn("brute") if shadowed else None
    pcast = traversal.cast_rays if shadowed else None
    want = np.asarray(jshade.point_light_illumination(ja, jattrs, jax_lights(), cast=jcast))
    got = shade.point_light_illumination(pa, pattrs, port_lights(), cast=pcast).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if shadowed:
        free = shade.point_light_illumination(pa, pattrs, port_lights()).numpy()
        assert (got < free).any() and (got > 0).any()  # some points in a point shadow


@pytest.mark.parametrize("sun", [True, False])
@pytest.mark.parametrize("mode", ["flat", "lambert", "lambert_shadow", "blinn_phong"])
def test_compute_illumination_with_point_lights_matches_jax(mode, sun):
    ja, _, pa, d, jattrs, pattrs = config4()
    ldir = LIGHT if sun else None
    want = np.asarray(jshade.compute_illumination(
        ja, jattrs, ldir, mode, backend="brute", directions=d, point_lights=jax_lights()))
    got = shade.compute_illumination(pa, pattrs, ldir, mode, backend="cuda",
                                     directions=torch.from_numpy(np.array(d)),
                                     point_lights=port_lights()).numpy()
    rtol = 2e-6 if mode == "blinn_phong" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    if mode != "flat":
        alone = shade.compute_illumination(pa, pattrs, ldir, mode, backend="cuda",
                                           directions=torch.from_numpy(np.array(d))).numpy()
        assert (got > alone).any()  # the point lights add light


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("clamp_floor", [None, 0.4])
def test_direct_illumination_with_point_lights_matches_jax(clamp_floor, shadows):
    ja, _, pa, _, jattrs, pattrs = config4()
    want = np.asarray(jint._direct_illumination(ja, jax_cast_fn("brute"), jattrs, LIGHT,
                                                jax_lights(), True, shadows,
                                                clamp_floor=clamp_floor))
    got = integrators._direct_illumination(pa, traversal.cast_rays, pattrs, LIGHT,
                                           port_lights(), True, shadows,
                                           occ_cast=occlusion_cast_fn("cuda"),
                                           clamp_floor=clamp_floor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def frames_agree(got, want, bound=FRAME_MAX_PIXELS):
    off = (np.asarray(got) != np.asarray(want)).any(-1)
    # a differing pixel is a truncation step apart, never more
    step = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max()
    print(f"{int(off.sum())} of {off.size} pixels differ, by at most {step}")
    assert off.sum() <= bound
    assert step <= 1 or off.sum() == 0


@pytest.mark.parametrize("sun,normal_mode", [(True, "reference"), (False, "inverse_transpose")])
def test_whitted_frame_with_point_lights_matches_jax(sun, normal_mode):
    ja, cam, pa, _, _, _ = config4()
    kw = dict(light_direction=LIGHT if sun else None, normal_mode=normal_mode)
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    want = jax_whitted(JaxConfig(32, 32, backend="brute", point_lights=jax_lights(), **kw),
                       ja, *args)
    got = render_image_whitted(RenderConfig(32, 32, point_lights=port_lights(), **kw), pa,
                               *(torch.from_numpy(np.array(a)) for a in args))
    frames_agree(got.numpy(), want)


def test_primary_lit_frame_with_point_lights_matches_jax():
    ja, cam, pa, _, _, _ = config4()
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    want = jax_render(JaxConfig(32, 32, backend="brute", lighting="lambert_shadow",
                                point_lights=jax_lights()), ja, *args)
    got = render_image(RenderConfig(32, 32, lighting="lambert_shadow",
                                    point_lights=port_lights()), pa,
                       *(torch.from_numpy(np.array(a)) for a in args))
    frames_agree(got.numpy(), want)


def test_path_frame_with_point_lights_matches_jax():
    """Path tracing with NEE toward the sun and the point lights: one
    bounce, two samples, the same key (``test_torch_path.py``'s bound:
    a pixel may flip where a bounce direction rounds an ulp apart)."""
    ja, cam = jscenes.scene_cornell(16)
    p = cam.ray_params()
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    lights = ((1.0, 1.0, 1.8, 3.0),)
    want = np.asarray(jax_render_path(
        JaxConfig(16, 16, backend="brute", path_lights=True, point_lights=jax_lights(lights)),
        ja, *args, jax.random.PRNGKey(5), 1, 2))
    got = render_image_path_traced(
        RenderConfig(16, 16, path_lights=True, point_lights=port_lights(lights)),
        from_scene_arrays(jax_fields(ja), device="cpu"),
        *(torch.from_numpy(np.array(a)) for a in args), prng.PRNGKey(5), 1, 2).numpy()
    off = (got != want).any(-1)
    print(f"{int(off.sum())} of {off.size} path pixels differ")
    assert off.mean() <= 0.01


@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
@pytest.mark.parametrize("name", ["two_instance", "instances"])
def test_normal_modes_under_nonuniform_scale_match_jax(name, normal_mode):
    if name == "instances":
        ja, cam, pa, d, _, _ = config4()
        p = cam.ray_params()
        o, d = jax_generate_rays(32, 32, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    else:
        ja, _ = compiled(name, "jax")
        pa = from_scene_arrays(jax_fields(ja), device="cpu")
        o, d = jax_rays(name)
    scales = np.asarray(ja.inst_scale)
    assert (scales.max(1) != scales.min(1)).any()  # a nonuniform scale
    jhit = jax_cast_fn("brute")(ja, o, d)
    want = jax_hit_attributes(ja, o, d, jhit, normal_mode=normal_mode)
    po, pd = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    got = hit_attributes(pa, po, pd, traversal.cast_rays(pa, po, pd), normal_mode=normal_mode)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(want.hit))
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit],
                               rtol=1e-6, atol=1e-6)
    other = hit_attributes(pa, po, pd, traversal.cast_rays(pa, po, pd),
                           normal_mode="reference" if normal_mode != "reference"
                           else "inverse_transpose")
    assert (other.normal != got.normal)[got.hit].any()  # the modes differ under this scale


def vn_obj(subdivisions=2, mixed=True) -> str:
    """An icosphere as OBJ text with a ``vn`` per vertex (its unit
    position), faces ``v//vn``; with ``mixed`` the first face lists no
    normals (it keeps its face normal)."""
    v0, v1, v2 = js.procgen.icosphere(subdivisions)
    lines = []
    for k, tri in enumerate(zip(v0, v1, v2)):
        for v in tri:
            lines.append("v {:.6f} {:.6f} {:.6f}".format(*v))
            n = v / np.linalg.norm(v)
            lines.append("vn {:.6f} {:.6f} {:.6f}".format(*n))
        a = 3 * k + 1
        if mixed and k == 0:
            lines.append(f"f {a} {a + 1} {a + 2}")
        else:
            lines.append(f"f {a}//{a} {a + 1}//{a + 1} {a + 2}//{a + 2}")
    return "\n".join(lines) + "\n"


def test_parse_obj_vertex_normals_matches_jax():
    text = vn_obj() + "f 1/1/1 2/2/2 3/3 \nf 4//4 5//5 6//6 7//7\n"
    want = js.objloader.parse_obj_vertex_normals(text)
    got = ts.objloader.parse_obj_vertex_normals(text)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[3][0] and got[3][1:].any()


@functools.lru_cache(maxsize=None)
def vn_scenes():
    """The vn icosphere, posed and nonuniformly scaled beside a plain cube
    (no vertex normals), compiled by both packages."""
    out = []
    for S in (js, ts):
        scene = S.Scene()
        scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2)))
        scene.add_mesh(S.objloader.loads(vn_obj(), vertex_normals=True))
        scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
        a = S.MeshInstance(0, 0)
        a.pose = np.array([0.3, 0.2, 0.0, 0.3, 0.2, 0.0], np.float32)
        a.scale = np.array([1.0, 1.3, 0.8], np.float32)
        scene.add_mesh_instance(a)
        b = S.MeshInstance(1, 0)
        b.pose = np.array([-1.6, 1.0, 0.0, 0.0, 0.0, 0.0], np.float32)
        scene.add_mesh_instance(b)
        out.append(scene.compile() if S is js else scene.compile(device="cpu"))
    return tuple(out)


def test_compiled_vertex_normals_match_jax():
    ja, pa = vn_scenes()
    want = np.asarray(ja.tri_vnorm)
    got = pa.tri_vnorm.numpy()
    assert got.shape == want.shape and got.shape[1] == 10
    np.testing.assert_array_equal(got, want)
    # pad rows and the cube's triangles are zero; the first face is flagged off
    assert (got[:, 9] == 0).any() and (got[:, 9] == 1).any()
    for name, f in jax_fields(ja).items():
        if name.startswith("tri_"):
            np.testing.assert_array_equal(getattr(pa, name).numpy(), f, err_msg=name)
    back = from_scene_arrays({**pa.numpy_fields()}, device="cpu")
    np.testing.assert_array_equal(back.tri_vnorm.numpy(), want)
    assert pa.to("cpu").tri_vnorm is not None


@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
def test_smooth_normals_match_jax(normal_mode):
    ja, pa = vn_scenes()
    cam = JaxCamera.looking(32, 32, fov_deg=60.0, pose=[-0.5, -4.0, 0.0, 0, 0, 0])
    p = cam.ray_params()
    o, d = jax_generate_rays(32, 32, p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    want = jax_hit_attributes(ja, o, d, jax_cast_fn("brute")(ja, o, d), normal_mode=normal_mode)
    po, pd = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    got = hit_attributes(pa, po, pd, traversal.cast_rays(pa, po, pd), normal_mode=normal_mode)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(want.hit))
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit],
                               rtol=1e-6, atol=1e-6)
    flat = hit_attributes(dataclasses.replace(pa, tri_vnorm=None), po, pd,
                          traversal.cast_rays(pa, po, pd), normal_mode=normal_mode)
    assert (flat.normal != got.normal)[got.hit].any()  # smooth differs from flat
    jimg = jax_render(JaxConfig(32, 32, backend="brute", lighting="lambert",
                                normal_mode=normal_mode), ja, p["K_inv"], p["D"], p["pose"],
                      p["inv_pose"])
    img = render_image(RenderConfig(32, 32, lighting="lambert", normal_mode=normal_mode), pa,
                       *(torch.from_numpy(np.array(p[k])) for k in
                         ("K_inv", "D", "pose", "inv_pose")))
    frames_agree(img.numpy(), jimg)
