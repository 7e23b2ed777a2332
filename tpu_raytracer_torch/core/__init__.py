from . import transforms, vecmath

__all__ = ["transforms", "vecmath"]
