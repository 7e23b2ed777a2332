"""The system under test: the port ``tpu_raytracer_torch``, driven through
its public API only (``Scene``, ``Material``, ``MeshPrimitive``,
``MeshInstance``, ``Scene.compile``, ``RenderConfig`` and the compiled
entries of ``render/pipeline.py``).

``import_port`` takes the port from the checkout the harness sits in,
never from anywhere else on the path. ``Frames`` builds a configuration's
scene and binds the traffic's entry; ``frame(K_inv, D, pose, inv_pose,
key)`` renders one frame from host tensors (the entry copies them in)
and returns the u8 image on the scene's device.
"""

from __future__ import annotations

import importlib
import os
import sys

PORT = "tpu_raytracer_torch"
# the traffic's "entry" -> the compiled entry point of render/pipeline.py
ENTRIES = {
    "image": "compiled_render_image",
    "path_traced": "compiled_render_image_path_traced",
    "ao": "compiled_render_image_ao",
}


def import_port(root: str):
    """The port's package from ``root``; raises ImportError where it is not
    there."""
    if root not in sys.path:
        sys.path.insert(0, root)
    mod = importlib.import_module(PORT)
    where = os.path.dirname(os.path.abspath(mod.__file__))
    if os.path.dirname(where) != os.path.abspath(root):
        raise ImportError(f"{PORT} was found at {where}, outside the checkout {root}")
    return mod


class Frames:
    """A configuration's scene on ``device`` and the traffic's compiled
    entry."""

    def __init__(self, config: dict, traffic: dict, tris, device, cache_dir: str):
        from tpu_raytracer_torch.render import RenderConfig, pipeline
        from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene

        scene = Scene()
        scene.add_material(Material(albedo=tuple(config["albedo"])))
        v0, v1, v2 = tris
        scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2, cache_dir=cache_dir))
        scene.add_mesh_instance(MeshInstance(0, 0))
        self.scene = scene.compile(str(device))
        self.pipeline = pipeline
        self.entry = getattr(pipeline, ENTRIES[traffic["entry"]])
        self.cfg = RenderConfig(traffic["width"], traffic["height"], backend="cuda",
                                lighting=traffic.get("lighting", "flat"))
        self.kind = kind = traffic["entry"]
        if kind == "path_traced":
            self.static = (traffic["max_bounces"], traffic["samples"])
        elif kind == "ao":
            self.static = (traffic["samples"], traffic["radius"])
        else:
            self.static = ()
        self.keyed = kind != "image"

    def frame(self, K_inv, D, pose, inv_pose, key):
        args = (self.cfg, self.scene, K_inv, D, pose, inv_pose)
        if self.keyed:
            args += (key,)
        return self.entry(*args, *self.static)

    def close(self) -> None:
        """Drop the scene and every compiled entry (their graphs and pools)."""
        self.pipeline.clear_compiled()
        self.scene = self.entry = None
