"""BASELINE config 5 on the tree ``bench_all.py``'s config 5b renders it
on: the frozen colonnade (``scenes.colonnade``) as one mesh whose BVH
the port builds with ``opt_rounds`` rounds of its reinsertion optimizer
(``accel/optimize.py``, after Bittner et al. 2013), under one material
and one identity instance, as ``scenes.scene`` gives a frozen generator's
mesh. ``opt_rounds`` is a ``MeshPrimitive.from_triangles`` keyword, which
``system.build_scene`` passes on; the reference reads only ``v0``-``v2``.
"""

from __future__ import annotations

import numpy as np

from rtbench import scenes


def scene(columns_x: int = 10, columns_y: int = 10, segs: int = 32, bands: int = 40,
          opt_rounds: int = 2, albedo=(0.85, 0.8, 0.75)):
    """The colonnade's description, its mesh built with ``opt_rounds``."""
    v0, v1, v2 = scenes.colonnade(columns_x, columns_y, segs, bands)
    return {"meshes": [{"v0": v0, "v1": v1, "v2": v2, "opt_rounds": opt_rounds}],
            "materials": [{"albedo": tuple(albedo)}],
            "instances": [(0, 0, np.zeros(6, np.float32), np.ones(3, np.float32))]}
