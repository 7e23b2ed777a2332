"""tpu_raytracer_torch — the PyTorch/CUDA port of ``tpu_raytracer``.

Same layout as the JAX package (``core``, ``scene``, ``render``,
``kernels``, ``app``) so every module has an obvious counterpart, but
written in PyTorch's idiom: plain functions on tensors, an explicit
``device`` on every scene and ray tensor, no jit and no pytrees. The
kernels the ported paths run — the 4-wide BVH traversal (K1), the
two-level TLAS traversal (K3), each in nearest- and any-hit modes, and
the paged traversals of big scenes (K4, K5, K6) — are hand-written CUDA
kernels (``kernels/csrc``) with plain PyTorch versions beside them that
CPU tensors use. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.

The port imports ``torch`` and never ``jax``, nor anything of the JAX
package: its host BVH builders (``accel``, with the native C++ builder
in ``accel/csrc``) are its own copies.
"""

__version__ = "0.1.0"
