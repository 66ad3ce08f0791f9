"""Matrix-product state over discretized position wavefunctions
(counterpart of ``quantum_computations_tpu/cv/mps.py``).

Each site is a rank-3 tensor (bond_left, len(domain), bond_right). Bond
dimensions may be zero-padded (see :mod:`..ops.linalg`); all contractions
are padding-transparent. ``MPS.fidelity`` computes the actual overlap
|<a|b>|^2, as the JAX package does.

The domain is a host numpy grid; :attr:`MPS.qs` is its float64 copy on the
state's device, made once. All site tensors share one device and one
complex dtype.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

from ..config import complex_dtype, full_fp32_matmul, resolve_device
from ..ops.linalg import tensor_svd  # re-export for API parity

__all__ = ["MPS", "tensor_svd"]


def _env_step(res, t):
    """res_{ab} t_{aci} conj(t)_{bcj} -> res_{ij} (transfer-matrix sweep)."""
    return torch.einsum("ab,aci,bcj->ij", res, t, torch.conj(t))


class MPS:
    """Chain of rank-3 tensors (bond_left, len(domain), bond_right).

    ``device`` and ``dtype`` default to those of the first tensor; an empty
    chain defaults to ``cuda`` and :func:`..config.complex_dtype` of it.
    Tensors on another device or dtype are moved; a 1-D tensor becomes
    (1, d, 1).
    """

    def __init__(self, domain, tensors, *, device=None, dtype=None):
        tensors = [torch.as_tensor(t) for t in tensors]
        if device is None:
            device = tensors[0].device if tensors else resolve_device(None)
        self.device = resolve_device(device)
        if dtype is None:
            dtype = (tensors[0].dtype if tensors and tensors[0].is_complex()
                     else complex_dtype(self.device))
        self.dtype = dtype
        self.tensors = [
            (t.reshape(1, -1, 1) if t.ndim == 1 else t).to(self.device, dtype)
            for t in tensors
        ]
        self.domain = np.asarray(domain)
        self.diff = abs(self.domain[-1] - self.domain[0]) / (len(self.domain) - 1)
        self.qs = torch.as_tensor(self.domain, dtype=torch.float64, device=self.device)
        self.validate()

    @classmethod
    def from_numpy(cls, domain, tensors, device=None, dtype=None) -> "MPS":
        """An MPS from numpy site arrays, on ``device`` (default ``cuda``)
        in ``dtype`` (default :func:`..config.complex_dtype` of it)."""
        device = resolve_device(device)
        dtype = dtype or complex_dtype(device)
        return cls(domain, [torch.from_numpy(np.asarray(t)) for t in tensors],
                   device=device, dtype=dtype)

    def to_numpy(self) -> list[np.ndarray]:
        """The site tensors as numpy arrays (host copies)."""
        return [t.cpu().resolve_conj().numpy() for t in self.tensors]

    # -- list protocol ------------------------------------------------------
    def __getitem__(self, index):
        return self.tensors[index]

    def __setitem__(self, index, value):
        self.tensors[index] = value

    def __len__(self):
        return len(self.tensors)

    def __iter__(self):
        return iter(self.tensors)

    def copy(self) -> "MPS":
        return MPS(self.domain.copy(), list(self.tensors), device=self.device,
                   dtype=self.dtype)

    def shape(self):
        return tuple(tuple(t.shape) for t in self.tensors)

    # -- validation ---------------------------------------------------------
    def validate(self):
        if self.domain.ndim != 1:
            raise TypeError("Domain must be a 1D array.")
        if not np.allclose(np.diff(self.domain, 2), 0, atol=np.finfo(self.domain.dtype).eps**0.5):
            raise ValueError("Domain is not an arithmetic progression.")
        if len(self.tensors) == 0:
            return
        for idx, tensor in enumerate(self.tensors):
            if tensor.ndim != 3:
                raise ValueError(f"Tensor at index {idx} does not have exactly three axes.")
            if tensor.shape[1] != len(self.domain):
                raise ValueError(f"Tensor at index {idx} does not have the right physical dimension.")
        if self.tensors[0].shape[0] != 1:
            raise ValueError("Left-most tensor does not have a trivial left edge")
        if self.tensors[-1].shape[2] != 1:
            raise ValueError("Right-most tensor does not have a trivial right edge")
        for idx, (t1, t2) in enumerate(zip(self.tensors, self.tensors[1:])):
            if t1.shape[2] != t2.shape[0]:
                raise ValueError(
                    f"Tensors at indices {idx} and {idx+1} do not have compatible bond dimensions."
                )

    # -- contractions -------------------------------------------------------
    def _one(self) -> torch.Tensor:
        return torch.ones((1, 1), dtype=self.dtype, device=self.device)

    @full_fp32_matmul()
    def contract(self) -> torch.Tensor:
        """Full dense wavefunction (use only for tiny chains)."""
        res = reduce(lambda t1, t2: torch.tensordot(t1, t2, dims=1), self.tensors)
        return torch.squeeze(res)

    @full_fp32_matmul()
    def norm(self) -> torch.Tensor:
        res = reduce(_env_step, self.tensors, self._one())
        res = res[0, 0] * self.diff ** len(self.tensors)
        return torch.sqrt(res.real)

    @full_fp32_matmul()
    def partial_density_mps(self, axis: int) -> torch.Tensor:
        """Single-mode reduced density matrix (grid-sampled, d x d)."""
        if axis < 0 or axis >= len(self.tensors):
            raise IndexError(f"axis={axis} out of bounds")
        left = reduce(_env_step, self.tensors[:axis], self._one())
        right = reduce(
            lambda res, t: torch.einsum("ica,jcb,ab->ij", t, torch.conj(t), res),
            self.tensors[axis + 1 :][::-1],
            self._one(),
        )
        t = self.tensors[axis]
        result = torch.einsum("ab,aic,bjd,cd->ij", left, t, torch.conj(t), right)
        return result * self.diff ** (len(self.tensors) - 1)

    def density_mps(self) -> list[torch.Tensor]:
        """Density-operator MPS: per-site tensors with two physical axes,
        D_k = t_k (x) conj(t_k) reshaped to (l^2, d, d, r^2)."""
        out = []
        for t in self.tensors:
            l, d, r = t.shape
            D = torch.einsum("aib,cjd->acijbd", t, torch.conj(t))
            out.append(D.reshape(l * l, d, d, r * r))
        return out

    @staticmethod
    @full_fp32_matmul()
    def fidelity(a: "MPS", b: "MPS") -> torch.Tensor:
        """|<a|b>|^2 with the grid measure."""
        res = reduce(
            lambda r, ts: torch.einsum("ab,aci,bcj->ij", r, ts[0], torch.conj(ts[1])),
            zip(a.tensors, b.tensors),
            a._one(),
        )
        return torch.abs(res[0, 0] * a.diff ** len(a)) ** 2
