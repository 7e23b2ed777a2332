"""The port's core math and ray generation against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: ``q_rsqrt`` bit for bit; normalize and the transforms at
rtol 1e-6 with atol 1e-6 for components near zero, where sin/cos of two
libraries may differ by an ulp of a larger intermediate (1e-5 where that
intermediate is a point of magnitude ~15, see TRANSFORM_ATOL); primary
rays at atol 1e-6 (a few ulp: XLA's and PyTorch's arctan/sqrt may
differ by an ulp). The round-trip properties of tests/test_transforms.py
hold on the port as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_raytracer.core import transforms as JT
from tpu_raytracer.core import vecmath as JV
from tpu_raytracer.render import camera as jcam
from tpu_raytracer_torch.core import transforms as PT
from tpu_raytracer_torch.core import vecmath as PV
from tpu_raytracer_torch.render import camera as pcam

torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def rand_pose(n):
    xyz = RNG.uniform(-10, 10, (n, 3))
    euler = RNG.uniform(-1.2, 1.2, (n, 3))  # clear of gimbal lock
    return np.concatenate([xyz, euler], -1).astype(np.float32)


def rand_vec(n, scale=5.0):
    return RNG.uniform(-scale, scale, (n, 3)).astype(np.float32)


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_q_rsqrt_bit_exact():
    x = np.concatenate([RNG.uniform(1e-6, 1e6, 4096), [1.0, 0.25, 3.0]]).astype(np.float32)
    got = PV.q_rsqrt(torch.from_numpy(x)).numpy()
    want = np.asarray(JV.q_rsqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("exact", [True, False])
def test_normalize_matches_jax(exact):
    v = rand_vec(512)
    close(PV.normalize(torch.from_numpy(v), exact=exact),
          JV.normalize(jnp.asarray(v), exact=exact))


def test_dot_apply_mat3_invert_intrinsic_match_jax():
    a, b = rand_vec(256), rand_vec(256)
    np.testing.assert_array_equal(PV.dot(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(JV.dot(jnp.asarray(a), jnp.asarray(b))))
    m = RNG.uniform(-2, 2, (256, 3, 3)).astype(np.float32)
    close(PV.apply_mat3(torch.from_numpy(m), torch.from_numpy(a)),
          JV.apply_mat3(jnp.asarray(m), jnp.asarray(a)))
    K = jcam.default_intrinsics(640, 360, 55.0)
    close(PV.invert_intrinsic(torch.from_numpy(K)), JV.invert_intrinsic(K))


def test_cross_and_magnitude_match_jax():
    a, b = rand_vec(512), rand_vec(512)
    np.testing.assert_array_equal(PV.cross(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(JV.cross(jnp.asarray(a), jnp.asarray(b))))
    close(PV.magnitude(torch.from_numpy(a)), JV.magnitude(jnp.asarray(a)))
    # the cross product is perpendicular to both factors
    c = PV.cross(torch.from_numpy(a), torch.from_numpy(b))
    close(PV.dot(c, torch.from_numpy(a)), np.zeros(512, np.float32), atol=1e-4)


def test_pose_matches_jax():
    args = [float(x) for x in rand_pose(1)[0]]
    np.testing.assert_array_equal(PT.pose(*args).numpy(), np.asarray(JT.pose(*args)))
    np.testing.assert_array_equal(PT.pose(y=2.5, roll=0.25).numpy(),
                                  np.asarray(JT.pose(y=2.5, roll=0.25)))
    assert PT.pose().dtype == torch.float32 and tuple(PT.pose().shape) == (6,)


TRANSFORMS = {
    "euler2rotmat": lambda M, p, v: M.euler2rotmat(p[..., 3:6]),
    "rotmat2euler": lambda M, p, v: M.rotmat2euler(M.euler2rotmat(p[..., 3:6])),
    "invert_rotmat": lambda M, p, v: M.invert_rotmat(M.euler2rotmat(p[..., 3:6])),
    "euler2quat": lambda M, p, v: M.euler2quat(p[..., 3:6]),
    "apply_quat": lambda M, p, v: M.apply_quat(M.euler2quat(p[..., 3:6]), v),
    "apply_euler": lambda M, p, v: M.apply_euler(p[..., 3:6], v),
    "lre2homo": lambda M, p, v: M.lre2homo(p),
    "homo2lre": lambda M, p, v: M.homo2lre(M.lre2homo(p)),
    "invert_homo": lambda M, p, v: M.invert_homo(M.lre2homo(p)),
    "apply_lre": lambda M, p, v: M.apply_lre(p, v),
    "invert_lre": lambda M, p, v: M.invert_lre(p),
    "pose_xyz": lambda M, p, v: M.pose_xyz(p),
    "pose_euler": lambda M, p, v: M.pose_euler(p),
    "compose_homo": lambda M, p, v: M.compose_homo(M.lre2homo(p[1:]), M.lre2homo(p[:-1])),
    "compose_lre": lambda M, p, v: M.compose_lre(p[1:], p[:-1]),
}


# Results that rotate points of magnitude ~15 (|v - xyz|), or that go
# through atan2/asin of rotated matrices, carry an ulp of that magnitude
# from a one-ulp difference in sin/cos: absolute 1e-5 there.
TRANSFORM_ATOL = {"apply_lre": 1e-5, "homo2lre": 1e-5, "invert_lre": 1e-5,
                  "rotmat2euler": 1e-5, "compose_homo": 1e-5, "compose_lre": 1e-5}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    p, v = rand_pose(128), rand_vec(128)
    fn = TRANSFORMS[name]
    got = fn(PT, torch.from_numpy(p), torch.from_numpy(v))
    want = fn(JT, jnp.asarray(p), jnp.asarray(v))
    close(got, want, atol=TRANSFORM_ATOL.get(name, 1e-6))


def test_transform_roundtrips():
    p = torch.from_numpy(rand_pose(64))
    v = torch.from_numpy(rand_vec(64))
    e = p[..., 3:6]
    close(PT.apply_euler(e, v), PV.apply_mat3(PT.euler2rotmat(e), v), atol=1e-5)
    close(PT.rotmat2euler(PT.euler2rotmat(e)), e, atol=1e-5)
    close(PT.homo2lre(PT.lre2homo(p)), p, atol=1e-4)
    back = PT.apply_lre(PT.invert_lre(p), PT.apply_lre(p, v))
    close(back, v, atol=1e-4)
    # composing a pose with its inverse is the identity
    close(PT.compose_lre(p, PT.invert_lre(p)), torch.zeros_like(p), atol=1e-4)


@pytest.mark.parametrize("w,h,fov,pose,exact", [
    (64, 64, 45.0, [0, -4, 0, 0, 0, 0], True),
    (96, 64, 50.0, [0.0, -3.2, 0.13, 0, 0, 0], True),
    (64, 48, 60.0, [0.3, -2.0, 0.5, 0.2, -0.1, 0.05], True),
    (64, 48, 60.0, [0.3, -2.0, 0.5, 0.2, -0.1, 0.05], False),
])
def test_generate_rays_matches_jax(w, h, fov, pose, exact):
    jc = jcam.Camera.looking(w, h, fov_deg=fov, pose=pose)
    pc = pcam.Camera.looking(w, h, fov_deg=fov, pose=pose)
    close(pc.K_inv, jc.K_inv)
    jp, pp = jc.ray_params(), pc.ray_params(device="cpu")
    jo, jd = jcam.generate_rays(w, h, jp["K_inv"], jp["D"], jp["pose"], jp["inv_pose"],
                                exact=exact)
    po, pd = pcam.generate_rays(w, h, pp["K_inv"], pp["D"], pp["pose"], pp["inv_pose"],
                                exact=exact)
    assert tuple(pd.shape) == (h, w, 3) and tuple(po.shape) == (3,)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    close(pd, jd, rtol=0.0, atol=1e-6)


def test_generate_rays_fisheye_calibration_matches_jax():
    K, D = jcam.reference_calibration(96, 54)
    pK, pD = pcam.reference_calibration(96, 54)
    np.testing.assert_array_equal(pK, K)
    np.testing.assert_array_equal(pD, D)
    jc = jcam.Camera(96, 54, K, D, pose=[0, -3, 0.2, 0.1, 0, 0])
    pc = pcam.Camera(96, 54, pK, pD, pose=[0, -3, 0.2, 0.1, 0, 0])
    jp, pp = jc.ray_params(), pc.ray_params(device="cpu")
    _, jd = jcam.generate_rays(96, 54, jp["K_inv"], jp["D"], jp["pose"], jp["inv_pose"])
    _, pd = pcam.generate_rays(96, 54, pp["K_inv"], pp["D"], pp["pose"], pp["inv_pose"])
    close(pd, jd, rtol=0.0, atol=1e-6)


def _intersect_inputs():
    o = rand_vec(256)
    d = np.array(JV.normalize(jnp.asarray(rand_vec(256))))
    v0, v1, v2 = rand_vec(256, 2.0), rand_vec(256, 2.0), rand_vec(256, 2.0)
    n = np.array(JV.normalize(jnp.cross(jnp.asarray(v1 - v0), jnp.asarray(v2 - v0))))
    uv = [RNG.uniform(0, 1, (256, 2)).astype(np.float32) for _ in range(3)]
    t = RNG.uniform(0, 5, 256).astype(np.float32)
    lo = rand_vec(256, 2.0)
    hi = lo + RNG.uniform(0.1, 2.0, (256, 3)).astype(np.float32)
    # directions with exact zeros, for safe_reciprocal's clamp
    d_zeros = np.where(RNG.uniform(0, 1, (256, 1)) > 0.3, d, 0.0).astype(np.float32)
    return dict(o=o, d=d, d_zeros=d_zeros, v0=v0, v1=v1, v2=v2, n=n, uv0=uv[0],
                uv1=uv[1], uv2=uv[2], t=t, lo=lo, hi=hi)


INTERSECT = {
    "ray_plane_hit": lambda M, a: M.ray_plane_hit(a["o"], a["d"], a["v0"], a["n"]),
    "barycentric_rows": lambda M, a: M.barycentric_rows(a["v0"], a["v1"], a["v2"]),
    "barycentric_uv": lambda M, a: M.barycentric_uv(a["o"], a["d"], a["t"], a["v0"],
                                                    a["v1"], a["v2"]),
    "bary_interp": lambda M, a: M.bary_interp(a["t"], a["t"] * 0.5, a["uv0"], a["uv1"],
                                              a["uv2"]),
    "point_in_triangle_uv": lambda M, a: M.point_in_triangle_uv(
        a["o"], a["d"], a["t"], a["v0"], a["v1"], a["v2"], a["uv0"], a["uv1"], a["uv2"]),
    "ray_aabb_entry": lambda M, a: M.ray_aabb_entry(a["o"], M.safe_reciprocal(a["d"]),
                                                    a["lo"], a["hi"]),
    "safe_reciprocal": lambda M, a: M.safe_reciprocal(a["d_zeros"]),
}


@pytest.mark.parametrize("name", sorted(INTERSECT))
def test_intersect_matches_jax_exactly(name):
    """Same f32 ops in the same order on both sides: bit for bit."""
    from tpu_raytracer.render import intersect as JI
    from tpu_raytracer_torch.render import intersect as PI

    a = _intersect_inputs()
    got = INTERSECT[name](PI, {k: torch.from_numpy(v) for k, v in a.items()})
    want = INTERSECT[name](JI, {k: jnp.asarray(v) for k, v in a.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w_ in zip(got, want, strict=True):
        g, w_ = g.numpy(), np.asarray(w_)
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)
