"""Casts, the 4-wide tables K1 walks: their SAH cost (``kernels/wide4.py
wide_sah``: ``sah_cost`` with both costs 1 over the wide nodes and their
leaves), the ``wide_sah`` info of the port's latest ``rt.setup.compile``
span (``Scene.compile``), one a mesh, weighted by each mesh's
``wide_triangles``. None where the port records no such info, and where
the scene compiled no resident 4-wide tables (the big-scene route)."""

import importlib


def read(ctx):
    try:
        profiling = importlib.import_module("tpu_raytracer_torch.utils.profiling")
    except ImportError:
        return None
    compiles = [s for s in getattr(profiling, "spans", list)() if s.name == "setup.compile"]
    info = compiles[-1].info if compiles else None
    if not info or "wide_sah" not in info:
        return None
    costs, tris = info["wide_sah"], info["wide_triangles"]
    return sum(c * t for c, t in zip(costs, tris)) / sum(tris)
