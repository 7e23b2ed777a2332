"""tpu_raytracer_torch — the PyTorch/CUDA port of ``tpu_raytracer``.

Same layout as the JAX package (``core``, ``scene``, ``render``,
``kernels``, ``app``) so every module has an obvious counterpart, but
written in PyTorch's idiom: plain functions on tensors, an explicit
``device`` on every scene and ray tensor, no jit and no pytrees. The one
kernel the primary-ray path runs — the 4-wide BVH traversal — is a
hand-written CUDA kernel (``kernels/csrc``) with a plain PyTorch version
beside it that CPU tensors use.

The port imports ``torch`` and never ``jax``; it borrows only the JAX
package's jax-free host BVH builders (``tpu_raytracer.accel``).
"""

__version__ = "0.1.0"
