"""Browser live viewer (counterpart of ``tpu_raytracer/app/web.py``): a
windowed display with mouse input, served from the render host by the
standard library's ``http.server``.

    python -m tpu_raytracer_torch.app.driver --scene instances --web 8000

  * dragging the image orbits the camera with the reference's
    sensitivity (yaw += dx * 0.001, pitch -= dy * 0.001; kernel.cu:131-132,
    through ``app.controls.orbit``, as the terminal viewer does);
  * W/A/S/D (and Q/E down and up) fly along the pose's axes
    (kernel.cu:51-104);
  * the page's <img> re-requests ``/frame.png`` as each frame loads, and
    every request renders one frame at the current pose.

Frames render on the scene's device (the card for a scene compiled
there) through the config's backend, one at a time: the server answers
on threads, and one render lock holds the card's work and the copy of
the frame to the host, so no two frames interleave. The frame is
encoded as a PNG (``utils/image.py:encode_png``) outside the lock.
"""

from __future__ import annotations

import contextlib
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core import transforms as T
from ..render import RenderConfig
from ..render.pipeline import compiled_render_image
from ..utils import prng
from ..utils.image import encode_png
from .controls import fly, orbit
from .driver import AO_SAMPLES, MODES

_PAGE = """<!doctype html>
<title>tpu-raytracer</title>
<style>body{margin:0;background:#111;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;cursor:grab}
#hud{position:fixed;top:8px;left:8px;color:#7f7;font:12px monospace}
</style>
<div id="hud">drag: orbit &nbsp; wasd/qe: fly</div>
<img id="v" width="%WIDTH%" height="%HEIGHT%">
<script>
const v = document.getElementById('v');
let busy = false;
function refresh() {
  if (busy) return; busy = true;
  const img = new Image();
  img.onload = () => { v.src = img.src; busy = false; requestAnimationFrame(refresh); };
  img.onerror = () => { busy = false; setTimeout(refresh, 500); };
  img.src = '/frame.png?' + Date.now();
}
refresh();
let drag = null;
v.addEventListener('pointerdown', e => { drag = [e.clientX, e.clientY]; v.setPointerCapture(e.pointerId); });
v.addEventListener('pointerup', () => drag = null);
v.addEventListener('pointermove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch('/drag?dx=' + dx + '&dy=' + dy, {method: 'POST'});
});
window.addEventListener('keydown', e => {
  if ('wasdqe'.includes(e.key)) fetch('/key?k=' + e.key, {method: 'POST'});
});
</script>"""


class WebViewer:
    """Serve a live, interactive render of ``scene`` (compiled on its
    device) from ``camera``'s starting pose. The pose state is
    thread-safe; each frame request renders one frame.

    ``mode`` selects the integrator as the driver's does: primary |
    whitted | path | ao. Path mode renders progressively: each frame adds
    a frame of ``path_samples`` samples to a float32 radiance sum on the
    scene's device, which restarts when the camera moves; only the
    tonemapped u8 frame leaves the device. Path and AO frames draw from
    ``fold_in(PRNGKey(0), frames_rendered)``; AO takes 8 samples within
    ``ao_radius``."""

    def __init__(self, scene, camera, config: RenderConfig | None = None,
                 move_step: float = 0.15, mode: str = "primary", path_samples: int = 2,
                 path_bounces: int = 3, ao_radius: float = 1.0):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.scene = scene
        self.camera = camera
        self.config = config or RenderConfig(width=camera.width, height=camera.height)
        self.move_step = float(move_step)
        self.mode = mode
        self.path_samples = int(path_samples)
        self.path_bounces = int(path_bounces)
        self.ao_radius = float(ao_radius)
        self._lock = threading.Lock()
        # one frame at a time: the server renders on its handler threads
        self._render_lock = threading.Lock()
        self._pose = np.array(camera.pose, np.float32)
        self._pose_version = 0
        p = camera.ray_params(scene.device)
        self._K_inv, self._D = p["K_inv"], p["D"]
        self.frames_rendered = 0
        self._accum = None  # path mode: radiance sum on the device
        self._accum_n = 0  # frames in the sum
        self._accum_version = -1  # the pose version the sum belongs to

    # -- input (the kernel.cu mouse/WASD semantics) ----------------------
    def on_drag(self, dx: float, dy: float) -> None:
        with self._lock:
            self._pose = orbit(self._pose, dx, dy)
            self._pose_version += 1

    def on_key(self, k: str) -> None:
        step = self.move_step
        move = {
            "w": dict(forward=step), "s": dict(forward=-step),
            "a": dict(right=-step), "d": dict(right=step),
            "q": dict(up=-step), "e": dict(up=step),
        }.get(k)
        if move:
            with self._lock:
                self._pose = fly(self._pose, **move)
                self._pose_version += 1

    def pose(self) -> np.ndarray:
        with self._lock:
            return self._pose.copy()

    def _pose_state(self):
        with self._lock:
            return self._pose.copy(), self._pose_version

    # -- rendering ---------------------------------------------------------
    def render_u8(self) -> np.ndarray:
        """One frame at the current pose -> host uint8 [H, W, 3]."""
        from ..render.integrators import to_u8, tonemap
        from ..render.pipeline import (
            compiled_render_image_ao, compiled_render_image_whitted,
            compiled_render_radiance_path_traced,
        )

        pose, version = self._pose_state()
        pose_t = torch.from_numpy(pose)
        dev = self.scene.device
        on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with self._render_lock, on_card:
            # the host pose goes to the compiled frame, which copies it in
            args = (self.config, self.scene, self._K_inv, self._D, pose_t, T.invert_lre(pose_t))
            if self.mode in ("path", "ao"):
                key = prng.fold_in(prng.PRNGKey(0, device=dev), self.frames_rendered)
            if self.mode == "whitted":
                img = compiled_render_image_whitted(*args)
            elif self.mode == "path":
                rad = compiled_render_radiance_path_traced(*args, key, self.path_bounces,
                                                           self.path_samples)
                if self._accum is None or self._accum_version != version:
                    self._accum, self._accum_n = rad, 1
                    self._accum_version = version
                else:
                    self._accum = self._accum + rad
                    self._accum_n += 1
                img = to_u8(tonemap(self._accum / self._accum_n, self.config.tonemap,
                                    self.config.exposure))
            elif self.mode == "ao":
                img = compiled_render_image_ao(*args, key, AO_SAMPLES, self.ao_radius)
            else:
                img = compiled_render_image(*args)
            img = img.cpu().numpy()
            self.frames_rendered += 1
        return img

    def render_frame(self) -> bytes:
        """One frame at the current pose as PNG bytes."""
        return encode_png(self.render_u8())

    # -- server --------------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
        viewer = self
        page = (_PAGE.replace("%WIDTH%", str(self.config.width))
                .replace("%HEIGHT%", str(self.config.height))).encode()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    self._send(200, page, "text/html")
                elif path == "/frame.png":
                    self._send(200, viewer.render_frame(), "image/png")
                elif path == "/pose":
                    body = json.dumps({"pose": [float(x) for x in viewer.pose()],
                                       "frames": viewer.frames_rendered,
                                       "spp": viewer._accum_n * viewer.path_samples}).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                u = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(u.query)
                if u.path == "/drag":
                    viewer.on_drag(float(q.get("dx", ["0"])[0]), float(q.get("dy", ["0"])[0]))
                elif u.path == "/key":
                    viewer.on_key(q.get("k", [""])[0][:1])
                else:
                    self._send(404, b"not found", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        # loopback by default: the viewer has no auth, its POST endpoints
        # move the camera and its GETs occupy the card; pass
        # host="0.0.0.0" (the driver's --web-host) to expose it
        srv = self.make_server(host, port)
        shown = "localhost" if host in ("0.0.0.0", "") else host
        print(f"live viewer on http://{shown}:{srv.server_address[1]}/ "
              "(drag to orbit, wasd/qe to fly, ctrl-c to stop)", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
