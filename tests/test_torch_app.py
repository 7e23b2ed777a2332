"""The port's app layer on the CPU against the JAX package's: the terminal
viewer (``app/interactive.py``), the browser viewer (``app/web.py``), the
FPS overlay, profiling (``utils/profiling.py``), the driver's ``--web``
flags and the bench scripts.

Tolerances:
  * ``ansi_preview`` and ``overlay_fps``: string and bit equal.
  * ``apply_key``: every pose within 1e-6 of JAX's (both fly in f32 with
    their own rotation code), the same action.
  * Primary and Whitted frames: equal (the same scenes through the ``bvh``
    or ``brute`` casts, which round as JAX's eager casts do).
  * Path frames: at most ``PATH_MAX_MISMATCH`` pixels apart, the bound
    ``tests/test_torch_path.py`` states for config 5's golden (bounce
    rays that a direction a few ulps off sends elsewhere); the
    progressive sums count the same samples.
  * AO frames: equal. Their 8 occlusion samples a pixel come from the
    same keys as JAX's, and at 32x32 none of their directions, a few
    ulps off JAX's, flips an answer (``tests/test_torch_path.py``'s
    ``render_ao`` parity, which also measures 0).
"""

import importlib.util
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import tpu_raytracer.app.interactive as jint
import tpu_raytracer.render as jr
import tpu_raytracer.scene as js
import tpu_raytracer_torch.render as tr
import tpu_raytracer_torch.scene as ts
from tpu_raytracer.app.web import WebViewer as JaxViewer
from tpu_raytracer.utils import overlay_fps as jax_overlay
from tpu_raytracer_torch.app import driver, interactive
from tpu_raytracer_torch.app.web import WebViewer
from tpu_raytracer_torch.utils import overlay_fps
from tpu_raytracer_torch.utils.image import decode_png
from tpu_raytracer_torch.utils.profiling import trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_path.py GOLDEN5_MAX_MISMATCH
PATH_MAX_MISMATCH = 16


def _pixels(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(-1).sum())


# -- the terminal viewer -------------------------------------------------------

@pytest.mark.parametrize("shape,cols", [((64, 64), 16), ((48, 80), 80), ((33, 17), 9),
                                        ((10, 300), 40)])
def test_ansi_preview_equals_jax(shape, cols):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), np.uint8)
    assert interactive.ansi_preview(img, cols) == jint.ansi_preview(img, cols)
    assert interactive.ansi_preview(torch.from_numpy(img), cols) == jint.ansi_preview(img, cols)


@pytest.mark.parametrize("key", list("wasdqeijkl") + ["x", "\x1b", "p", "+", "-", "z", "r"])
def test_apply_key_equals_jax(key):
    rng = np.random.default_rng(ord(key))
    pose = rng.uniform(-2, 2, 6).astype(np.float32)
    speed = float(rng.uniform(0.05, 0.5))
    got, action = interactive.apply_key(pose, key, speed)
    want, jax_action = jint.apply_key(pose, key, speed)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    assert action == jax_action
    assert interactive.ORBIT_STEP == jint.ORBIT_STEP


def test_run_interactive_scripted_equals_jax(tmp_path):
    """``wwjpx`` on the cube at 32x32 through ``bvh``: the frame after two
    steps and an orbit, the shot written on ``p``, the loop ended on
    ``x``; the same frame as JAX's viewer."""
    kw = dict(scene_name="cube", width=32, height=32, backend="bvh")
    got = interactive.run_interactive(keys=iter("wwjpx"), out=str(tmp_path / "p.png"),
                                      device="cpu", **kw)
    want = jint.run_interactive(keys=iter("wwjpx"), out=str(tmp_path / "j.png"), **kw)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)
    assert os.path.exists(tmp_path / "p.png")
    first = interactive.run_interactive(keys=iter(""), out=str(tmp_path / "0.png"),
                                        device="cpu", **kw)
    assert _pixels(first, got) > 0  # the keys moved the camera


def test_run_interactive_progressive_path_equals_jax(tmp_path):
    """``zz`` in path mode (``z`` is unmapped: the camera holds still, so
    the sum counts 3 frames of one sample, keys split from ``PRNGKey(0)``
    once per frame): the port's own sum bit for bit, and within the path
    bound of JAX's frame."""
    from tpu_raytracer_torch.app.scenes import scene_cube
    from tpu_raytracer_torch.render.integrators import to_u8, tonemap
    from tpu_raytracer_torch.render.pipeline import render_radiance_path_traced
    from tpu_raytracer_torch.utils import prng

    kw = dict(scene_name="cube", width=32, height=32, backend="bvh", mode="path", bounces=1)
    got = interactive.run_interactive(keys=iter("zz"), out=str(tmp_path / "p.png"),
                                      device="cpu", **kw)
    want = jint.run_interactive(keys=iter("zz"), out=str(tmp_path / "j.png"), **kw)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3) and got.std() > 0
    scene, cam = scene_cube(32, device="cpu")
    p = cam.ray_params("cpu")
    cfg = tr.RenderConfig(32, 32, backend="bvh")
    rng, acc = prng.PRNGKey(0), None
    for _ in range(3):
        rng, k = prng.split(rng)
        rad = render_radiance_path_traced(cfg, scene, p["K_inv"], p["D"], p["pose"],
                                          p["inv_pose"], k, max_bounces=1, samples=1)
        acc = rad if acc is None else acc + rad
    np.testing.assert_array_equal(got, to_u8(tonemap(acc / 3, "reinhard")).numpy())
    differ = _pixels(got, want)
    print(f"progressive path: {differ} of 1024 pixels differ from JAX's")
    assert differ <= PATH_MAX_MISMATCH


def test_run_interactive_refuses_unknown_modes():
    with pytest.raises(ValueError, match="primary and path"):
        interactive.run_interactive(scene_name="cube", keys=iter(""), mode="whitted",
                                    device="cpu")


# -- the browser viewer --------------------------------------------------------

def _sphere(S, R):
    """``tests/test_web.py``'s scene: one icosphere."""
    scene = S.Scene()
    scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2)))
    scene.add_mesh(S.MeshPrimitive.from_triangles(*S.procgen.icosphere(1)))
    scene.add_mesh_instance(S.MeshInstance(0, 0))
    return scene, R.Camera.looking(32, 32, fov_deg=55.0, pose=[0, -3.5, 0, 0, 0, 0])


def _mirror_pair(S, R):
    """``tests/test_web.py``'s mode scene: a reflective sphere over a board."""
    scene = S.Scene()
    scene.add_material(S.Material(albedo=(0.8, 0.3, 0.2), reflectivity=0.5))
    scene.add_material(S.Material(albedo=(0.2, 0.6, 0.9)))
    scene.add_mesh(S.MeshPrimitive.from_triangles(*S.procgen.icosphere(1)))
    scene.add_mesh(S.objloader.loads(S.procgen.board_obj(4.0, 4.0)))
    scene.add_mesh_instance(S.MeshInstance(0, 0))
    floor = S.MeshInstance(1, 1)
    floor.pose = np.array([0.0, 0.0, -1.2, 0.0, 0.0, 0.0], np.float32)
    scene.add_mesh_instance(floor)
    return scene, R.Camera.looking(32, 32, fov_deg=55.0, pose=[0, -3.5, 1.0, 0, 0, 0])


def _viewers(recipe, **kw):
    port_scene, port_cam = recipe(ts, tr)
    jax_scene, jax_cam = recipe(js, jr)
    return (WebViewer(port_scene.compile("cpu"), port_cam, tr.RenderConfig(32, 32,
                                                                           backend="brute"), **kw),
            JaxViewer(jax_scene.compile(), jax_cam, jr.RenderConfig(32, 32, backend="brute"),
                      **kw))


def _jax_frame(viewer) -> np.ndarray:
    import cv2

    return cv2.imdecode(np.frombuffer(viewer.render_frame(), np.uint8), cv2.IMREAD_COLOR)


def test_web_viewer_http_surface():
    viewer, jax_viewer = _viewers(_sphere)
    srv = viewer.make_server(host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    post = lambda path: urllib.request.urlopen(urllib.request.Request(base + path,
                                                                      method="POST"), timeout=30)
    try:
        page = urllib.request.urlopen(f"{base}/", timeout=30).read()
        assert b"pointermove" in page and b"/frame.png" in page
        assert page.startswith(b"<!doctype html>") and b'width="32" height="32"' in page

        png1 = urllib.request.urlopen(f"{base}/frame.png", timeout=120).read()
        assert png1[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(decode_png(png1), _jax_frame(jax_viewer))

        # a drag orbits at the reference's 0.001 rad per pixel
        assert post("/drag?dx=200&dy=-100").status == 200
        pose1 = viewer.pose()
        assert abs(pose1[3] - 0.2) < 1e-6 and abs(pose1[4] - 0.1) < 1e-6
        assert post("/key?k=w").status == 200  # WASD flies along the pose's axes
        assert not np.allclose(viewer.pose()[:3], pose1[:3])
        jax_viewer.on_drag(200, -100)
        jax_viewer.on_key("w")
        np.testing.assert_allclose(viewer.pose(), jax_viewer.pose(), rtol=0, atol=1e-6)

        png2 = urllib.request.urlopen(f"{base}/frame.png", timeout=120).read()
        assert png2 != png1
        np.testing.assert_array_equal(decode_png(png2), _jax_frame(jax_viewer))
        stat = json.loads(urllib.request.urlopen(f"{base}/pose", timeout=30).read())
        assert stat["frames"] == 2 and len(stat["pose"]) == 6 and stat["spp"] == 0
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"{base}/nothing", timeout=30)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            post("/nothing")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_web_viewer_modes_equal_jax():
    """Primary and Whitted frames equal JAX's viewer's at the same pose;
    path frames within the path bound, their sums counting alike (held
    still: 1, 2; moved: back to 1); AO equal, with the same keys."""
    for mode in ("primary", "whitted"):
        port, jax_viewer = _viewers(_mirror_pair, mode=mode)
        np.testing.assert_array_equal(decode_png(port.render_frame()), _jax_frame(jax_viewer))
    port_prim, _ = _viewers(_mirror_pair)
    port_whit, _ = _viewers(_mirror_pair, mode="whitted")
    assert port_whit.render_frame() != port_prim.render_frame()  # reflections show

    port, jax_viewer = _viewers(_mirror_pair, mode="path", path_samples=1, path_bounces=1)
    counts, frames = [], []
    for step in ("hold", "hold", "drag"):
        if step == "drag":
            port.on_drag(50, 0)
            jax_viewer.on_drag(50, 0)
        got, want = decode_png(port.render_frame()), _jax_frame(jax_viewer)
        frames.append(got)
        counts.append((port._accum_n, jax_viewer._accum_n))
        differ = _pixels(got, want)
        print(f"path frame {len(frames)}: {differ} of 1024 pixels differ from JAX's")
        assert differ <= PATH_MAX_MISMATCH
    assert counts == [(1, 1), (2, 2), (1, 1)]
    assert _pixels(frames[0], frames[1]) > 0  # the average moved

    port, jax_viewer = _viewers(_mirror_pair, mode="ao", ao_radius=0.7)
    for _ in range(2):
        got, want = decode_png(port.render_frame()), _jax_frame(jax_viewer)
        np.testing.assert_array_equal(got, want)
        assert (got[..., 0] == got[..., 2]).all()
    with pytest.raises(ValueError, match="unknown mode"):
        WebViewer(None, None, mode="bogus")


def test_web_viewer_input_without_server():
    viewer, _ = _viewers(_sphere)
    p0 = viewer.pose()
    viewer.on_drag(100, 50)
    viewer.on_key("d")
    p1 = viewer.pose()
    assert not np.allclose(p0, p1)
    viewer.on_key("z")  # unknown keys are ignored
    np.testing.assert_array_equal(viewer.pose(), p1)
    assert viewer._pose_version == 2


def test_web_viewer_serializes_frames_across_threads():
    """Frames requested from 8 threads at once: each renders alone (the
    render lock), none is lost, every one is the still camera's frame."""
    viewer, _ = _viewers(_sphere)
    want = viewer.render_u8()
    inside, worst, out = [0], [0], []
    import tpu_raytracer_torch.app.web as web

    render = web.compiled_render_image

    def watched(*a, **k):
        inside[0] += 1
        worst[0] = max(worst[0], inside[0])
        time.sleep(0.002)
        try:
            return render(*a, **k)
        finally:
            inside[0] -= 1

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    web.compiled_render_image = watched
    try:
        threads = [threading.Thread(target=lambda: out.append(viewer.render_u8()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        web.compiled_render_image = render
        sys.setswitchinterval(saved)
    assert worst[0] == 1 and len(out) == 8 and viewer.frames_rendered == 9
    assert all(np.array_equal(f, want) for f in out)


# -- the FPS overlay, profiling ---------------------------------------------

@pytest.mark.parametrize("fps", [42.5, 1234.56789, 0.0])
def test_overlay_fps_equals_jax(fps):
    img = np.random.default_rng(3).integers(0, 256, (48, 200, 3), np.uint8)
    got = overlay_fps(img, fps)
    np.testing.assert_array_equal(got, jax_overlay(img, fps))
    assert got.dtype == np.uint8 and (got != img).any()
    np.testing.assert_array_equal(overlay_fps(torch.from_numpy(img), fps), got)
    assert (img == np.random.default_rng(3).integers(0, 256, (48, 200, 3), np.uint8)).all()


def test_overlay_fps_without_opencv_is_unlabelled(monkeypatch):
    img = np.random.default_rng(4).integers(0, 256, (40, 64, 3), np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = overlay_fps(img, 60.0)
    np.testing.assert_array_equal(got, img)
    assert not np.shares_memory(got, img)  # a copy


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    scene, cam = _sphere(ts, tr)
    scene = scene.compile("cpu")
    with trace(str(tmp_path / "tr"), device="cpu") as log_dir:
        tr.render(cam, scene, backend="brute")
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert log_dir == str(tmp_path / "tr") and len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


# -- the driver's web flags --------------------------------------------------------

def test_driver_web_flags_reach_the_viewer(monkeypatch):
    served = []

    def fake_serve(self, host="127.0.0.1", port=8000):
        served.append((self.mode, self.ao_radius, host, port, self.config.width,
                       self.scene.device.type))

    monkeypatch.setattr(WebViewer, "serve", fake_serve)
    monkeypatch.setattr("sys.argv", ["driver", "--scene", "cube", "--width", "32", "--height",
                                     "32", "--device", "cpu", "--mode", "ao", "--ao-radius",
                                     "0.5", "--web", "8123", "--web-host", "0.0.0.0"])
    driver.main()
    assert served == [("ao", 0.5, "0.0.0.0", 8123, 32, "cpu")]
    assert driver.run("cube", 32, 32, device="cpu", web=0) is None
    assert served[-1][2:4] == ("127.0.0.1", 0)  # loopback by default


# -- the bench scripts ------------------------------------------------------

def _root_bench_all():
    spec = importlib.util.spec_from_file_location("root_bench_all",
                                                  os.path.join(REPO, "bench_all.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_all_has_the_root_configs_and_keys(capsys):
    from tpu_raytracer_torch import bench_all

    assert list(bench_all.CONFIGS) == list(_root_bench_all().CONFIGS)
    assert bench_all.main(["cube", "--device", "cpu", "--frames", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == {"config", "resolution", "frame_ms", "fps", "mrays_per_s", "card"}
    assert line["config"] == "1 cube 256^2 flat" and line["resolution"] == "256x256"
    assert line["card"] == "cpu" and line["frame_ms"] > 0
    assert line["mrays_per_s"] == pytest.approx(256 * 256 / line["frame_ms"] / 1e3)
    with pytest.raises(SystemExit):
        bench_all.main(["nonesuch", "--device", "cpu"])


def test_bench_paged_lines(capsys):
    from tpu_raytracer_torch import bench_paged
    from tpu_raytracer_torch.bench_all import Bench

    bench_paged.paged(Bench("cpu", "cuda", frames=4), columns=2, size=32)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["scene_tris"] > 10_000 and lines[0]["bvh_nodes"] > 0
    checks = [ln for ln in lines if "paged_vs_brute_t_close" in ln]
    assert [c["kernel"] for c in checks] == ["K4", "K5"]
    assert all(c["paged_vs_brute_t_close"] and c["t_unexplained_of_192"] == 0 for c in checks)
    assert sum("metric" in ln for ln in lines) == 3
    k6 = lines[-1]
    assert k6["metric"].startswith("page-major 2-instance")
    assert 0 < k6["pages_streamed_per_frame"] <= k6["item_grid"]
    assert k6["tile_items_per_frame"] >= k6["pages_streamed_per_frame"]
    assert k6["t_unexplained_of_96"] == 0 and k6["inst_id_diffs_of_96"] == 0
