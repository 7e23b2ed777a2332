"""Set-up, the BVH build: the SAH cost of the scene's binary trees
(``accel/bvh.py sah_cost``), the ``sah`` info of the port's
``rt.setup.bvh`` spans (``scene/mesh.py build_mesh_bvh``, on a build and
on a cache hit alike) weighted by each span's ``triangles``. The scene's
spans are the latest whose triangles add up to the scene's. None where
the port records no such info."""

import importlib


def read(ctx):
    try:
        profiling = importlib.import_module("tpu_raytracer_torch.utils.profiling")
    except ImportError:
        return None
    weighted, total = 0.0, 0
    for s in reversed(getattr(profiling, "spans", list)()):
        if s.name != "setup.bvh":
            continue
        if not s.info or "sah" not in s.info:
            return None
        weighted += s.info["sah"] * s.info["triangles"]
        total += s.info["triangles"]
        if total >= ctx.triangles:
            break
    return weighted / total if total == ctx.triangles else None
