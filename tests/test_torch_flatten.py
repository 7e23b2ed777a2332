"""``Scene.flattened`` and ``compile(flatten_static=True)`` of the port
against the JAX package's.

The bake to world space goes through each package's own transforms
(sin and cos of two libraries), so the flattened vertices and normals
are held to ``test_torch_core.TRANSFORM_ATOL``'s ``apply_lre`` tolerance
in each triangle's source order (a vertex an ulp off can move a split,
so the trees are compared only where the vertices are bit-equal);
``tri_mat`` and the uvs are exact. The port's renders of JAX's own
flattened ``SceneArrays`` (through ``from_scene_arrays``) must equal
JAX's pixel for pixel, and the port's flattened config 4 Whitted frame
may differ from its instanced frame on at most 3% of the pixels (exact-t
ties at shared edges and the bake's last bits; JAX's own flatten test,
``tests/test_scene.py``, allows the same).
"""

import numpy as np
import pytest
import torch

import tpu_raytracer.render as jr
import tpu_raytracer.scene as js
import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer_torch.app.scenes import scene_instances
from tpu_raytracer_torch.kernels import traversal
from tpu_raytracer_torch.render import RenderConfig, generate_rays, hit_attributes
from tpu_raytracer_torch.scene.scene import from_scene_arrays

from test_torch_core import TRANSFORM_ATOL
from test_torch_lights import vn_obj
from test_torch_scene import _two_instance, jax_fields

torch.set_num_threads(1)

ATOL = TRANSFORM_ATOL["apply_lre"]


def _three_instance(S, R):
    """The JAX tests' posed, scaled pair plus a vn icosphere, nonuniformly
    scaled: face and vertex normals both baked."""
    scene, cam = _two_instance(S, R)
    scene.add_material(S.Material(albedo=(0.2, 0.7, 0.3)))
    scene.add_mesh(S.objloader.loads(vn_obj(), vertex_normals=True))
    c = S.MeshInstance(2, 2)
    c.pose = np.array([0.2, -0.6, 0.9, 0.3, 0.2, 0.1], np.float32)
    c.scale = np.array([0.5, 0.7, 0.4], np.float32)
    scene.add_mesh_instance(c)
    return scene, cam


RECIPES = {"two_instance": _two_instance, "three_instance_vn": _three_instance}


def _source_order(mesh, arr):
    out = np.empty_like(arr)
    out[mesh.bvh.order] = arr
    return out


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_flattened_matches_jax(name):
    jflat, jmat = RECIPES[name](js, jr)[0].flattened()
    pflat, pmat = RECIPES[name](ts, tr)[0].flattened()
    assert len(pflat.meshes) == 1 and len(pflat.mesh_instances) == 1
    inst = pflat.mesh_instances[0]
    assert (inst.mesh_index, inst.material_index) == (0, 0)
    assert (inst.pose == 0).all() and (inst.scale == 1).all()
    pm, jm = pflat.meshes[0], jflat.meshes[0]
    assert pm.num_triangles == jm.num_triangles
    np.testing.assert_array_equal(_source_order(pm, pmat), _source_order(jm, jmat))
    fields = ["v0", "v1", "v2", "normal", "uv0", "uv1", "uv2"]
    if jm.vn0 is not None:
        fields += ["vn0", "vn1", "vn2", "vn_mask"]
    else:
        assert pm.vn0 is None
    exact = True
    for f in fields:
        a, b = _source_order(pm, getattr(pm, f)), _source_order(jm, getattr(jm, f))
        if f.startswith("uv") or f == "vn_mask":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f)
            exact &= bool(np.array_equal(a, b)) or not f.startswith("v")
    if exact:  # bit-equal vertices: the same tree
        for f in ("node_min", "node_max", "child_a", "child_b", "leaf_count", "order"):
            np.testing.assert_array_equal(getattr(pm.bvh, f), getattr(jm.bvh, f), err_msg=f)
    assert len(pflat.materials) == len(jflat.materials)


def test_compile_flatten_static_has_one_instance_and_per_triangle_materials():
    """JAX ``tests/test_scene.py::test_flatten_static_instances_matches_render``'s
    checks on the port: one mesh, one instance, ``tri_mat`` up to the
    textured material 1, -1 only on pad rows."""
    scene, cam = _two_instance(ts, tr)
    flat = scene.compile("cpu", flatten_static=True)
    assert flat.mesh_root.shape[0] == 1 and flat.num_instances == 1 and flat.tlas is None
    tri_mat = flat.tri_mat.numpy()
    assert tri_mat.max() == 1
    pad = (flat.tri_v0 == 0).all(1).numpy() & (flat.tri_normal == 0).all(1).numpy()
    np.testing.assert_array_equal(tri_mat < 0, pad)
    a = tr.render(cam, scene.compile("cpu"), backend="bvh", lighting="lambert")
    b = tr.render(cam, flat, backend="bvh", lighting="lambert")
    assert float((a == b).all(-1).float().mean()) > 0.97
    # the unflattened compile keeps -1 everywhere
    assert (scene.compile("cpu").tri_mat == -1).all()


@pytest.mark.parametrize("backend", ["bvh", "cuda"])
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_render_of_jax_flattened_arrays_equals_jax(name, backend):
    scene, cam = RECIPES[name](js, jr)
    jflat = scene.compile(flatten_static=True)
    want = np.asarray(jr.render(cam, jflat, backend="bvh", lighting="lambert"))
    fields = jax_fields(jflat)
    if jflat.tri_vnorm is not None:
        fields["tri_vnorm"] = np.asarray(jflat.tri_vnorm)
    pflat = from_scene_arrays(fields, device="cpu")
    pcam = RECIPES[name](ts, tr)[1]
    got = tr.render(pcam, pflat, backend=backend, lighting="lambert").numpy()
    assert int((got != want).any(-1).sum()) == 0


def test_flattened_config4_whitted_within_3_percent_of_instanced():
    inst, cam = scene_instances(64, 64, device="cpu")
    flat, _ = scene_instances(64, 64, device="cpu", flatten=True)
    assert inst.num_instances == 4 and flat.num_instances == 1
    assert int(flat.tri_mat.max()) == 3  # the textured floor's material
    p = cam.ray_params("cpu")
    args = (p["K_inv"], p["D"], p["pose"], p["inv_pose"])
    cfg = RenderConfig(64, 64, backend="cuda")
    a = tr.render_image_whitted(cfg, inst, *args)
    b = tr.render_image_whitted(cfg, flat, *args)
    same = float((a == b).all(-1).float().mean())
    assert same >= 0.97, same
    # materials resolve per triangle, in the redo and in the carried branch
    o, d = generate_rays(64, 64, *args)
    hi = traversal.cast_rays(inst, o, d)
    for carry in (False, True):
        hf = traversal.cast_rays(flat, o, d, want_normals=True, carry=carry)
        ai, af = hit_attributes(inst, o, d, hi), hit_attributes(flat, o, d, hf)
        both = ai.hit & af.hit & torch.isclose(ai.t, af.t, rtol=1e-5, atol=1e-5)
        assert float(both.float().mean()) > 0.5
        assert (ai.material[both] == af.material[both]).all()


def test_flattened_scene_drops_the_sky_as_jax_does():
    """``flattened`` leaves the sky map behind in both packages, so
    ``compile(flatten_static=True)`` of a sky scene renders the flat sky
    colour, pixel for pixel JAX's frame (the scene-sharded compile puts
    the sky back itself)."""
    scenes = {}
    for S, R in ((js, jr), (ts, tr)):
        scene, cam = _two_instance(S, R)
        scene.set_sky(S.procgen.sky_gradient_texture())
        scenes[S] = scene, cam
        assert scene.flattened()[0].sky_texture is None
    jscene, jcam = scenes[js]
    want = np.asarray(jr.render(jcam, jscene.compile(flatten_static=True), backend="bvh",
                                lighting="lambert"))
    pscene, pcam = scenes[ts]
    flat = pscene.compile("cpu", flatten_static=True)
    assert not flat.has_sky and pscene.compile("cpu").has_sky
    got = tr.render(pcam, flat, backend="bvh", lighting="lambert").numpy()
    assert int((got != want).any(-1).sum()) == 0
    miss = (got == np.array([255, 204, 153], np.uint8)).all(-1)
    assert miss.mean() > 0.3  # the flat sky colour, not the map
