"""Scene builders of the ported paths (counterpart of
``tpu_raytracer/app/scenes.py``), BASELINE configs 1-5:

| # | config | builder |
|---|--------|---------|
| 1 | cube, pinhole, flat | scene_cube |
| 2 | Cornell box, Lambert + hard shadows | scene_cornell |
| 3 | 82k-triangle displaced blob, 1080p | scene_bunny |
| 4 | posed, scaled instances + Whitted reflections | scene_instances |
|   | 16 instances, the TLAS scene | scene_instances16 |
| 5 | the colonnade, path traced: 256k triangles at the defaults, ~1.04M at 18x18 columns, 40 segments | scene_colonnade |
|   | two posed instances of that colonnade, the page-major scene | scene_colonnade_pair |

Config 5 is path tracing on the colonnade: BASELINE's run is
``scene_colonnade(512, 512)`` at its defaults (10x10 columns, 32
segments: 256,002 triangles), 2 samples and 2 bounces over a 5-pose
``controls.fly_through`` (``render_image_path_traced``); the ~1.04M
triangles at 18x18 columns and 40 segments are the paged kernels'
scene. ``flatten=True`` on configs 4 and 16 instances bakes the static
instances into one world-space mesh (``Scene.flattened``): bench_all's
configs 4b and 6b, one K1 walk in place of K3's.
"""

from __future__ import annotations

import numpy as np

from ..render import Camera
from ..scene import Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen


def scene_cube(size: int = 256, device="cuda"):
    scene = Scene()
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(128, 8))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(size, size, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene.compile(device), cam


def scene_cornell(size: int = 512, mirror: bool = False, device="cuda"):
    """Config 2: five walls and a cube, six instances."""
    scene = Scene()
    white = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    red = scene.add_material(Material(albedo=(0.1, 0.1, 0.9)))
    green = scene.add_material(Material(albedo=(0.1, 0.9, 0.1)))
    box_mat = scene.add_material(
        Material(albedo=(0.95, 0.95, 0.95), reflectivity=0.7 if mirror else 0.0))
    mats = {"floor": white, "ceiling": white, "back": white, "left": red, "right": green}
    for name, tris in procgen.cornell_box().items():
        mid = scene.add_mesh(MeshPrimitive.from_triangles(tris[:, 0], tris[:, 1], tris[:, 2]))
        scene.add_mesh_instance(MeshInstance(mid, mats[name]))
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj(0.6)))
    inst = MeshInstance(cube, box_mat)
    inst.pose = np.array([1.0, 1.2, 0.3, 0.4, 0, 0], np.float32)
    scene.add_mesh_instance(inst)
    cam = Camera.looking(size, size, fov_deg=70.0, pose=[1.0, -0.8, 1.0, 0, 0, 0])
    return scene.compile(device), cam


def scene_bunny(width: int = 1920, height: int = 1088, subdivisions: int = 6,
                device="cuda"):
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.blob(subdivisions=subdivisions)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    scene.add_mesh_instance(MeshInstance(0, 0))
    # z offset 0.13 keeps center-row rays off the blob's z=0 edge ring
    cam = Camera.looking(width, height, fov_deg=50.0, pose=[0.0, -3.2, 0.13, 0, 0, 0])
    return scene.compile(device), cam


def scene_instances(width: int = 512, height: int = 512, device="cuda", flatten: bool = False):
    """Config 4: a textured floor board, a mirror sphere, a scaled cube
    and a small sphere — four posed instances (one baked mesh with
    ``flatten``)."""
    scene = Scene()
    matte = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    blue = scene.add_material(Material(albedo=(0.9, 0.2, 0.1)))
    mirror = scene.add_material(Material(albedo=(0.95, 0.95, 0.95), reflectivity=0.8))
    tex = Material()
    tex.set_texture(procgen.checkerboard_texture(128, 8))
    texid = scene.add_material(tex)

    sphere = scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(4)))
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj()))
    board = scene.add_mesh(objloader.loads(procgen.board_obj(8, 8)))

    floor = MeshInstance(board, texid)
    floor.pose = np.array([0, 2, -1.2, 0, 0, np.pi], np.float32)  # face up
    scene.add_mesh_instance(floor)
    a = MeshInstance(sphere, mirror)
    a.pose = np.array([-1.2, 2.5, 0.0, 0, 0, 0], np.float32)
    scene.add_mesh_instance(a)
    b = MeshInstance(cube, blue)
    b.pose = np.array([1.1, 2.0, -0.6, 0.5, 0, 0], np.float32)
    b.scale = np.array([0.8, 0.8, 1.4], np.float32)
    scene.add_mesh_instance(b)
    c = MeshInstance(sphere, matte)
    c.pose = np.array([0.3, 3.5, -0.7, 0, 0, 0], np.float32)
    c.scale = np.array([0.5, 0.5, 0.5], np.float32)
    scene.add_mesh_instance(c)
    cam = Camera.looking(width, height, fov_deg=60.0, pose=[0, -1.5, 0.3, 0, 0, 0])
    return scene.compile(device, flatten_static=flatten), cam


def scene_instances16(width: int = 512, height: int = 512, n: int = 16, device="cuda",
                      flatten: bool = False):
    """16 posed, scaled instances of a cube and a sphere in a grid: the
    TLAS scene (one baked mesh with ``flatten``)."""
    scene = Scene()
    matte = scene.add_material(Material(albedo=(0.9, 0.9, 0.9)))
    red = scene.add_material(Material(albedo=(0.9, 0.2, 0.1)))
    sphere = scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(4)))
    cube = scene.add_mesh(objloader.loads(procgen.cube_obj()))
    rng = np.random.default_rng(11)
    side = int(np.ceil(np.sqrt(n)))
    for k in range(n):
        inst = MeshInstance(sphere if k % 2 else cube, matte if k % 2 else red)
        gx, gz = k % side, k // side
        inst.pose = np.array(
            [(gx - (side - 1) / 2) * 2.4, 4.0 + rng.uniform(-0.8, 0.8),
             (gz - (side - 1) / 2) * 2.4, rng.uniform(0, 3), rng.uniform(0, 1), 0.0],
            np.float32,
        )
        inst.scale = np.full(3, rng.uniform(0.7, 1.1), np.float32)
        scene.add_mesh_instance(inst)
    cam = Camera.looking(width, height, fov_deg=75.0, pose=[0, -8.0, 0.0, 0, 0, 0])
    return scene.compile(device, flatten_static=flatten), cam


def scene_colonnade(width: int = 1024, height: int = 1024, columns: int = 10,
                    segs: int = 32, device="cuda", opt_rounds: int = 0):
    """Config 5: a Sponza-class hall of columns; ``columns=18, segs=40``
    is the ~1.04M-triangle scene of the paged path
    (``tpu_raytracer/app/scenes.py:scene_colonnade``). ``opt_rounds``:
    rounds of the reinsertion optimizer on its BVH (bench_all's config 5b
    takes 2, where the JAX package reads ``TRT_BVH_OPT``)."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    v0, v1, v2 = procgen.colonnade(columns, columns, segs)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2, opt_rounds=opt_rounds))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(width, height, fov_deg=65.0, pose=[1.0, -2.0, 1.6, 0, 0, 0])
    return scene.compile(device), cam


def scene_colonnade_pair(width: int = 512, height: int = 512, columns: int = 18,
                         segs: int = 40, device="cuda"):
    """Two instances of the colonnade mesh, the second posed and scaled:
    the two-instance page-major scene of the JAX package's
    ``bench_paged.py:instanced_page_major`` (which builds its mesh with
    ``segs=40`` at any column count)."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.85, 0.8, 0.75)))
    v0, v1, v2 = procgen.colonnade(columns, columns, segs)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    b = MeshInstance(0, 0)
    b.pose = np.array([3.0, 40.0, 0.0, 0.0, 0.0, 0.6], np.float32)
    b.scale = np.array([0.9, 1.1, 0.8], np.float32)
    scene.add_mesh_instance(MeshInstance(0, 0))
    scene.add_mesh_instance(b)
    cam = Camera.looking(width, height, fov_deg=65.0, pose=[1.0, -2.0, 1.6, 0, 0, 0])
    return scene.compile(device), cam


def build_demo_scene() -> Scene:
    """The reference app's scene: a textured cube and a textured board
    posed in front of a fisheye camera, with procedural stand-ins for its
    image and mesh assets (``tpu_raytracer/app/driver.py``)."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.1, 0.2, 0.9), roughness=0.01))
    scene.add_material(Material(albedo=(0.9, 0.9, 0.9), roughness=0.3))
    cube_mat = Material()
    cube_mat.set_texture(procgen.checkerboard_texture(256, 16))
    scene.add_material(cube_mat)
    board_mat = Material()
    board_mat.set_texture(procgen.checkerboard_texture(256, 8))
    scene.add_material(board_mat)

    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh(objloader.loads(procgen.board_obj()))

    scene.add_mesh_instance(MeshInstance(0, 2))
    board_instance = MeshInstance(1, 3)
    board_instance.pose = np.array([-0.6, 1.48, 0.73, 0, 0, 0], np.float32)
    scene.add_mesh_instance(board_instance)
    return scene


# builders taking (width, height) except cube and cornell, which take one size
SCENES = {
    "cube": scene_cube,
    "cornell": scene_cornell,
    "bunny": scene_bunny,
    "instances": scene_instances,
    "instances16": scene_instances16,
    "colonnade": scene_colonnade,
}
