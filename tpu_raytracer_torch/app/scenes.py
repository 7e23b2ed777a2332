"""Scene builders of the ported primary path (counterpart of
``tpu_raytracer/app/scenes.py``): BASELINE config 1 (the textured cube)
and config 3's mesh (the 82k-triangle displaced blob). The Cornell box,
instanced and colonnade scenes wait for their kernels (ROADMAP items
8, 10 and 14)."""

from __future__ import annotations

from ..render import Camera
from ..scene import Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen


def scene_cube(size: int = 256, device="cpu"):
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(128, 8))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(size, size, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene.compile(device), cam


def scene_bunny(width: int = 1920, height: int = 1088, subdivisions: int = 6,
                device="cpu"):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.blob(subdivisions=subdivisions)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    # z offset 0.13 keeps center-row rays off the blob's z=0 edge ring
    cam = Camera.looking(width, height, fov_deg=50.0, pose=[0.0, -3.2, 0.13, 0, 0, 0])
    return scene.compile(device), cam


SCENES = {"cube": scene_cube, "bunny": scene_bunny}
