"""Hand-written kernels of the port and their plain PyTorch versions.

| Kernel | Replaces (TPU) | Source | Wrapper / plain version |
|---|---|---|---|
| K1 4-wide BVH traversal, nearest and any hit, optionally bounded by a t_max | ``kernels/dual.py:_dual_kernel`` (+ ``traversal.py:make_test_tri``) | ``csrc/wide_traverse.cu``, ``csrc/walk.cuh`` | ``traversal.cast_rays_cuda`` / ``traversal.cast_rays_wide_torch`` |
| K2 binary BVH traversal (K1's walk at arity 2), nearest and any hit, optionally bounded; the ``bvh`` backend | ``kernels/traversal.py:_traversal_kernel`` (and the XLA walk ``render/renderer.py:cast_rays_bvh``) | ``csrc/wide_traverse.cu``, ``csrc/walk.cuh`` | ``binary.cast_rays_binary_cuda`` / ``binary.cast_rays_binary_torch`` |
| K3 TLAS + 4-wide BLAS traversal, nearest and any hit | ``kernels/tlas.py:_tlas_kernel`` | ``csrc/tlas_traverse.cu``, ``csrc/tlas_traverse.cuh``, ``csrc/walk.cuh`` | ``tlas.cast_rays_tlas_cuda`` / ``tlas.cast_rays_tlas_torch`` |
| K4 paged traversal, 4-wide pages; the ``cuda`` and ``bvh`` backends' cast of a scene past the leaf code's rows (``traversal.needs_paging``) | ``kernels/paged_wide.py:_paged_wide_kernel`` | ``csrc/paged_traverse.cu``, ``csrc/paged_traverse.cuh``, ``csrc/walk.cuh`` | ``paged.cast_rays_paged_cuda`` / ``paged.cast_rays_paged_torch`` |
| K5 paged traversal, binary pages | ``kernels/paged.py:_paged_kernel`` | ``csrc/paged_traverse.cu``, ``csrc/paged_traverse.cuh``, ``csrc/walk.cuh`` | as K4, on binary tables |
| K6 page-major paged traversal | ``kernels/paged_major.py:_page_major_kernel`` | ``csrc/paged_major.cu``, ``csrc/paged_traverse.cuh``, ``csrc/walk.cuh``; its plan ``csrc/page_plan.cu``, ``csrc/page_plan.cuh`` | ``paged_major.cast_rays_paged_major_cuda`` / ``paged_major.cast_rays_paged_major_torch``; plan ``paged_major.page_major_plan_cuda`` / ``paged_major.page_major_plan`` |

Beside them, the frame's stages around the cast, which the JAX package
leaves to XLA's fusions of its jitted frame, are kernels too:

| Kernel | Replaces (JAX, XLA-fused) | Source | Wrapper / plain version |
|---|---|---|---|
| S1 raygen | ``render/camera.py:generate_rays`` | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.generate_rays_cuda`` / ``render/camera.py:generate_rays_torch`` |
| S2 hit attributes (redo and carried branches) | ``render/renderer.py:hit_attributes`` | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.hit_attributes_cuda`` / ``render/renderer.py:hit_attributes_torch`` |
| S3 primary shade (every lighting mode, point lights, the three texture filters, the sky map) | ``render/shade.py:shade_primary`` | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.shade_primary_cuda`` / ``render/shade.py:shade_primary_torch`` |
| S4 sample (threefry, uniform and the cosine sample of one draw, the path tracer's lobe uniforms) | ``render/integrators.py:_cosine_sample`` and the ``jax.random`` draws around it | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.sample_cosine_cuda`` / ``render/integrators.py:sample_cosine_torch`` |
| S5 Whitted shade (one bounce: the sky, the texel, the radiance and throughput sums, the parked reflected rays) | the shade body of ``render/integrators.py:render_whitted`` | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.whitted_shade_cuda`` / ``render/integrators.py:whitted_shade_torch`` |
| S6 path bounce (one bounce: the sky, the surface colour, the emission and NEE sums, the throughput, the lobe blend, the parked next rays; the fast tail's sky term) | the bounce body of ``render/integrators.py:render_path_traced`` | ``csrc/frame.cu``, ``csrc/frame.cuh`` | ``frame.path_bounce_cuda`` / ``render/integrators.py:path_bounce_torch`` |

All are built into one library, one nvcc per source (``build.py``):
every TPU kernel of the JAX package has its counterpart.
"""
