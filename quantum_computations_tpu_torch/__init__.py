"""PyTorch/CUDA port of :mod:`quantum_computations_tpu`, for one NVIDIA H100.

The JAX package is the reference this port is held against; the port
imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and none asked for they raise.

Ported so far: the DV large-N state-vector engine in its default slab mode
(:class:`.dv.FastStatevector`) and its hand-written Hopper kernel
(:func:`.ops.slab_kernels.slab_matmul`).
"""

from . import config

__all__ = ["config"]
