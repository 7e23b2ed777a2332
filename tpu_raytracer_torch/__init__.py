"""tpu_raytracer_torch — the PyTorch/CUDA port of ``tpu_raytracer``.

Same layout as the JAX package (``core``, ``scene``, ``render``,
``kernels``, ``app``) so every module has an obvious counterpart, but
written in PyTorch's idiom: plain functions on tensors, an explicit
``device`` on every scene and ray tensor, no jit and no pytrees. The
kernels the ported paths run — the 4-wide BVH traversal (K1) and the
two-level TLAS traversal (K3), each in nearest- and any-hit modes — are
hand-written CUDA kernels (``kernels/csrc``) with plain PyTorch versions
beside them that CPU tensors use.

The port imports ``torch`` and never ``jax``; it borrows only the JAX
package's jax-free host BVH builders (``tpu_raytracer.accel``).
"""

__version__ = "0.1.0"
