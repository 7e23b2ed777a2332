"""Compiled-scene disk cache (counterpart of ``tpu_raytracer/scene/cache.py``).

The reference rebuilds every BVH from OBJ text on every launch
(MeshPrimitive.cpp:14). ``compile_cached`` hashes everything that shapes
``Scene.compile``'s output (triangles, vertex normals, each mesh's built
tree, instances, materials, textures, the sky map and a format version)
and keeps the compiled scene as an npz (``SceneTensors.save``) named by
that hash, so a repeat run skips the build and the compile. An entry is
written to a temporary file and renamed into place; one that fails to
load is deleted and compiled again.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import zipfile
import zlib

import numpy as np

from .scene import Scene, SceneTensors

# Part of every key: change it whenever SceneTensors' fields or the
# compile's output change, so no old entry aliases a new scene.
FORMAT_VERSION = b"tpu_raytracer_torch-scene-v1"


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_raytracer_torch")


def scene_fingerprint(scene: Scene) -> str:
    """Content hash over everything that affects the compile's output."""
    h = hashlib.sha256(FORMAT_VERSION)

    def add(*arrays):
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())

    for mesh in scene.meshes:
        add(mesh.v0, mesh.v1, mesh.v2, mesh.normal, mesh.uv0, mesh.uv1, mesh.uv2)
        if mesh.vn0 is not None:
            h.update(b"vn")
            add(mesh.vn0, mesh.vn1, mesh.vn2, mesh.vn_mask)
        b = mesh.bvh
        add(b.node_min, b.node_max, b.child_a, b.child_b, b.leaf_start, b.leaf_count)
    for inst in scene.mesh_instances:
        add(np.int64([inst.mesh_index, inst.material_index]), inst.pose, inst.scale)
    for m in scene.materials:
        add(np.asarray([*m.albedo, m.roughness, m.metallic, m.illumination, m.reflectivity],
                       np.float32))
        if m.texture is not None:
            h.update(b"tex")
            add(np.int64(m.texture.shape), m.texture)
    if scene.sky_texture is not None:
        h.update(b"sky")
        add(np.int64(scene.sky_texture.shape), scene.sky_texture)
    return h.hexdigest()[:24]


def compile_cached(scene: Scene, cache_dir: str | None = None, device="cuda") -> SceneTensors:
    """``scene.compile(device)`` through the disk cache in ``cache_dir``
    (``default_cache_dir()`` unless given)."""
    cache_dir = pathlib.Path(cache_dir or default_cache_dir())
    fp = cache_dir / f"scene_{scene_fingerprint(scene)}.npz"
    if fp.exists():
        try:
            return SceneTensors.load(str(fp), device)
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile, zlib.error):
            fp.unlink(missing_ok=True)  # a corrupt entry: compile again and replace it
    tensors = scene.compile(device)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache_dir / f"{fp.stem}.tmp.{os.getpid()}.npz"
    try:
        tensors.save(str(tmp))
        os.replace(tmp, fp)
    finally:
        tmp.unlink(missing_ok=True)
    return tensors
