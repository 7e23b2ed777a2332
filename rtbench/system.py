"""The system under test: the port ``tpu_raytracer_torch``, driven through
its public API only (``Scene``, ``Material``, ``MeshPrimitive``,
``MeshInstance``, ``Scene.compile``, ``RenderConfig`` and the entries of
``render/pipeline.py``).

``import_port`` takes the port from the checkout the harness sits in,
never from anywhere else on the path. ``build_scene`` builds a scene
description (``scenes.py``) as the port's compiled scene. ``Frames``
builds a configuration's scene and binds the traffic's entry
(``entries/<entry>.py``); ``frame(K_inv, D, pose, inv_pose, key)``
renders one frame from host tensors (the entry copies them in) and
returns the u8 image on the scene's device.
"""

from __future__ import annotations

import importlib
import os
import sys

from . import spec

PORT = "tpu_raytracer_torch"


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


def build_scene(desc: dict, device, cache_dir):
    """The port's compiled scene of a description: every material (its
    texture set where it has one), every mesh (its BVH cached under
    ``cache_dir``), every instance with its pose and scale."""
    from tpu_raytracer_torch.scene import Material, MeshInstance, MeshPrimitive, Scene

    scene = Scene()
    for m in desc["materials"]:
        material = Material(**{k: v for k, v in m.items() if k != "texture"})
        if m.get("texture") is not None:
            material.set_texture(m["texture"])
        scene.add_material(material)
    for mesh in desc["meshes"]:
        scene.add_mesh(MeshPrimitive.from_triangles(**mesh, cache_dir=cache_dir))
    for mesh, material, pose, scale in desc["instances"]:
        scene.add_mesh_instance(MeshInstance(mesh, material, pose, scale))
    return scene.compile(str(device))


def _hashable(value):
    """JSON lists as tuples, so that a render option keys the compiled
    entries as the port's own tuples do."""
    return tuple(_hashable(v) for v in value) if isinstance(value, list) else value


class Frames:
    """A configuration's scene on ``device`` and the traffic's entry.

    ``RenderConfig`` takes the traffic's ``width``, ``height``,
    ``lighting`` (default flat) and every keyword of its optional
    ``render`` (``backend`` defaults to ``cuda``)."""

    def __init__(self, config: dict, traffic: dict, desc: dict, device, cache_dir: str):
        from tpu_raytracer_torch.render import RenderConfig, pipeline

        self.scene = build_scene(desc, device, cache_dir)
        self.pipeline = pipeline
        options = {"backend": "cuda", "lighting": traffic.get("lighting", "flat")}
        options.update({k: _hashable(v) for k, v in traffic.get("render", {}).items()})
        cfg = RenderConfig(traffic["width"], traffic["height"], **options)
        entry = spec.entry(traffic["entry"])
        self.keyed = entry.KEYED
        self._frame = entry.bind(pipeline, self.scene, cfg, traffic)

    def frame(self, K_inv, D, pose, inv_pose, key):
        return self._frame(K_inv, D, pose, inv_pose, key)

    def close(self) -> None:
        """Drop the scene and every compiled entry (their graphs and pools)."""
        self.pipeline.clear_compiled()
        self.scene = self._frame = None
