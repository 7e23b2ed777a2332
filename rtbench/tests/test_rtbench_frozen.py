"""The harness's frozen copies agree with the port's functions they copy:
the scene generators bit for bit, the fly-through, the pose maths, the
intrinsics and threefry."""

import numpy as np
import pytest
import torch

from rtbench import pose, prng, scenes
from tpu_raytracer_torch.app import controls
from tpu_raytracer_torch.core import transforms as T
from tpu_raytracer_torch.render import Camera
from tpu_raytracer_torch.scene import procgen
from tpu_raytracer_torch.utils import prng as port_prng


@pytest.mark.parametrize("name,args", [
    ("blob", {"subdivisions": 6, "radius": 1.0, "seed": 7}),
    ("blob", {"subdivisions": 3, "radius": 0.7, "seed": 3}),
    ("colonnade", {"columns_x": 10, "columns_y": 10, "segs": 32, "bands": 40}),
    ("colonnade", {"columns_x": 3, "columns_y": 2, "segs": 8, "bands": 5}),
    ("icosphere", {"subdivisions": 2}),
])
def test_generators_give_the_ports_triangles_bit_for_bit(name, args):
    ours = scenes.GENERATORS[name](**args)
    theirs = getattr(procgen, name)(**args)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_the_configurations_triangle_counts():
    assert len(scenes.blob(6, 1.0, 7)[0]) == 81920
    assert len(scenes.colonnade(10, 10, 32)[0]) == 256002


def test_fly_through_is_the_ports():
    start = np.array([3.0, 4.0, 1.6, 0.3, 0.0, 0.0], np.float32)
    ours = list(pose.fly_through(start, 20, 0.05, 0.01))
    theirs = list(controls.fly_through(start, 20, 0.05, 0.01))
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


def test_the_lap_is_the_path_fly_through_steps():
    table = pose.lap([11.0, 11.0], 1.6, 0.05, 0.01)
    assert len(table) == 628
    stepped = np.stack(list(pose.fly_through(table[0], 300, 0.05, 0.01)))
    np.testing.assert_allclose(stepped, table[1:301], atol=2e-4)
    # a circle of radius 5 about the centre
    r = np.hypot(table[:, 0] - 11.0, table[:, 1] - 11.0)
    assert np.all(np.abs(r - 5.0) < 0.01)


def test_the_lap_clears_every_column():
    table = pose.lap([11.0, 11.0], 1.6, 0.05, 0.01)
    cols = np.array([(x, y) for x in range(1, 20, 2) for y in range(1, 20, 2)], float)
    d = np.hypot(table[:, None, 0] - cols[None, :, 0], table[:, None, 1] - cols[None, :, 1])
    assert d.min() > 0.3 * 1.15 + 0.05 + 0.1  # the widest column radius plus 0.1


def test_the_turntable_looks_at_its_centre():
    table = pose.turntable([0.0, 0.0], 3.2, 0.13, 0.5)
    assert len(table) == 720
    np.testing.assert_array_equal(table[0], np.array([0, -3.2, 0.13, 0, 0, 0], np.float32))
    fwd = pose.apply_euler(pose.invert_lre(torch.from_numpy(table))[:, 3:6],
                           torch.tensor([0.0, 1.0, 0.0]).expand(720, 3)).numpy()
    to_centre = -table[:, :2] / np.linalg.norm(table[:, :2], axis=1, keepdims=True)
    np.testing.assert_allclose(fwd[:, :2], to_centre, atol=1e-5)


def test_pose_maths_and_intrinsics_are_the_ports():
    table = torch.from_numpy(pose.lap([11.0, 11.0], 1.6, 0.05, 0.01)[:50])
    torch.testing.assert_close(pose.invert_lre(table), T.invert_lre(table), rtol=0, atol=0)
    v = torch.randn(50, 3)
    torch.testing.assert_close(pose.apply_lre(table, v), T.apply_lre(table, v), rtol=0, atol=0)
    K, K_inv, D = pose.intrinsics(1920, 1080, 65.0)
    cam = Camera.looking(1920, 1080, fov_deg=65.0)
    np.testing.assert_array_equal(K.numpy(), cam.K)
    np.testing.assert_array_equal(K_inv.numpy(), cam.K_inv)
    np.testing.assert_array_equal(D.numpy(), cam.D)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 123])
def test_threefry_is_the_ports(seed):
    key = prng.PRNGKey(seed)
    assert torch.equal(key, port_prng.PRNGKey(seed))
    for frame in (0, 1, 977):
        assert torch.equal(prng.frame_key(seed, frame), port_prng.fold_in(key, frame))
        assert torch.equal(prng.fold_in(key, frame), port_prng.fold_in(key, frame))
    assert torch.equal(prng.split(key, 5), port_prng.split(key, 5))
    k = prng.split(key, 3)[1]
    assert torch.equal(prng.uniform(k, (4, 6, 2)), port_prng.uniform(k, (4, 6, 2)))
