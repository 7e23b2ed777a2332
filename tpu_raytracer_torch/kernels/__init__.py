"""Hand-written kernels of the port and their plain PyTorch versions.

| Kernel | Replaces (TPU) | Source | Wrapper / plain version |
|---|---|---|---|
| K1 4-wide BVH traversal, nearest hit | ``kernels/dual.py:_dual_kernel`` (+ ``traversal.py:make_test_tri``) | ``csrc/wide_traverse.cu``, ``csrc/wide_traverse.cuh`` | ``traversal.cast_rays_cuda`` / ``traversal.cast_rays_wide_torch`` |

The other TPU kernels (K2-K6 in ROADMAP.md) are not ported yet.
"""
