"""Device and dtype helpers of the port.

The JAX package reads its backend from JAX's own state
(``quantum_computations_tpu/config.py``); here the device is an explicit
argument. The default is ``cuda``; asking for it without a CUDA device
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"
REAL_DTYPE = torch.float32  # the state-vector engine's split-real planes


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device``, else ``cuda``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 matmuls and einsums in full FP32 (no TF32) inside the block,
    as the JAX package computes them (``Precision.HIGHEST``)."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
