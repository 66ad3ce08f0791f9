"""Device, dtype and truncation settings of the port (counterpart of
``quantum_computations_tpu/config.py``).

The JAX package reads its backend from JAX's own state; here the device is
an explicit argument. The default is ``cuda``; asking for it without a CUDA
device raises instead of carrying on on the CPU.

Dtypes follow the device: complex128 on the CPU (the parity dtype the tests
compare at), complex64 on CUDA. ``QCT_X64`` overrides both ways, as in the
JAX package, so the card can also run in complex128.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

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


def to_device(x, device: str | torch.device) -> torch.Tensor:
    """A host array or CPU tensor on ``device``. On CUDA the copy is staged
    through pinned memory and does not wait for the device (a copy from
    pageable memory synchronises)."""
    t = torch.as_tensor(x)
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _x64(device: str | torch.device | None) -> bool:
    env = os.environ.get("QCT_X64")
    if env:
        return env not in ("0", "false", "False")
    return torch.device(DEFAULT_DEVICE if device is None else device).type == "cpu"


def real_dtype(device: str | torch.device | None = None) -> torch.dtype:
    return torch.float64 if _x64(device) else torch.float32


def complex_dtype(device: str | torch.device | None = None) -> torch.dtype:
    return torch.complex128 if _x64(device) else torch.complex64


@dataclasses.dataclass(frozen=True)
class SVDOptions:
    """Truncation options for :func:`..ops.linalg.tensor_svd`.

    A simulator-wide options object is merged into each gate unless the gate
    overrides a field (:meth:`merged_into`).

    max_bond_dim: hard cap on kept singular values.
    abs_err / rel_err: allowed truncation error; the kept rank is the smallest
        r such that the sum of dropped singular values is below
        ``max(abs_err, sum(s) * rel_err)``.
    svd_method: "auto" (randomized when ``max_bond_dim * 10 < full_rank``),
        "full" (always the exact SVD) or "randomized" (always Halko).
    """

    max_bond_dim: int | None = None
    abs_err: float = 0.0
    rel_err: float = 1e-12
    svd_method: str = "auto"

    def merged_into(self, other: "SVDOptions | None") -> "SVDOptions":
        """Fields explicitly set on `other` win; unset fields fall back to self."""
        if other is None:
            return self
        updates = {
            f.name: getattr(other, f.name)
            for f in dataclasses.fields(other)
            if getattr(other, f.name) != f.default
        }
        return dataclasses.replace(self, **updates)


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 matmuls and einsums in full FP32 (no TF32) inside the block,
    as the JAX package computes them (``Precision.HIGHEST``). Also usable as
    a decorator."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
