"""Hand-written kernels of the port and their plain PyTorch versions.

| Kernel | Replaces (TPU) | Source | Wrapper / plain version |
|---|---|---|---|
| K1 4-wide BVH traversal, nearest and any hit | ``kernels/dual.py:_dual_kernel`` (+ ``traversal.py:make_test_tri``) | ``csrc/wide_traverse.cu``, ``csrc/wide_traverse.cuh`` | ``traversal.cast_rays_cuda`` / ``traversal.cast_rays_wide_torch`` |
| K3 TLAS + 4-wide BLAS traversal, nearest and any hit | ``kernels/tlas.py:_tlas_kernel`` | ``csrc/tlas_traverse.cu``, ``csrc/tlas_traverse.cuh`` | ``tlas.cast_rays_tlas_cuda`` / ``tlas.cast_rays_tlas_torch`` |

Both are built into one library by one nvcc command (``build.py``).
The other TPU kernels (K2, K4-K6 in ROADMAP.md) are not ported yet.
"""
