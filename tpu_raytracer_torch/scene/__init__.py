from . import cache, objloader, procgen
from .instance import MeshInstance
from .material import Material
from .mesh import MeshPrimitive
from .scene import Scene, SceneTensors, from_scene_arrays

__all__ = [
    "Material",
    "MeshInstance",
    "MeshPrimitive",
    "Scene",
    "cache",
    "SceneTensors",
    "from_scene_arrays",
    "objloader",
    "procgen",
]
