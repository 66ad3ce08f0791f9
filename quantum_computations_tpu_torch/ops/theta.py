"""Jacobi theta functions by a truncated series (counterpart of
``quantum_computations_tpu/ops/theta.py``).

theta3(z, tau) = 1 + 2 * sum_{n>=1} q^(n^2) cos(2 pi n z), q = exp(i pi tau),
with ``z`` the reference wrapper's pre-pi-scaled argument. Terms decay like
|q|^(n^2), so 64 terms reach float64 accuracy for every Im(tau) the
pipelines use. The series is always summed in complex128, on the device of
``z``; a scalar ``tau`` stays a host number.
"""

from __future__ import annotations

import math

import torch

DEFAULT_TERMS = 64


def _c128(z) -> torch.Tensor:
    return torch.as_tensor(z).to(torch.complex128)


def theta3(z, tau, terms: int = DEFAULT_TERMS) -> torch.Tensor:
    """Jacobi theta_3 in the reference's convention: jtheta(3, pi*z, exp(i pi tau))."""
    z = _c128(z)
    n = torch.arange(1, terms + 1, dtype=torch.float64, device=z.device)
    qn = torch.exp(1j * math.pi * tau * n**2)
    cos = torch.cos(2 * math.pi * z[..., None] * n)
    return 1.0 + 2.0 * torch.sum(qn * cos, dim=-1)


def modified_theta(a, b, z, tau, terms: int = DEFAULT_TERMS) -> torch.Tensor:
    """exp(pi i tau a^2 + 2 pi i a (z+b)) * theta3(z + a tau + b, tau)."""
    z = _c128(z)
    pre = torch.exp(math.pi * 1j * tau * a**2 + 2j * math.pi * a * (z + b))
    return pre * theta3(z + a * tau + b, tau, terms=terms)


def gaussians(s, delta_sq, alpha: float = 2 * math.sqrt(math.pi),
              terms: int = DEFAULT_TERMS) -> torch.Tensor:
    """Equally spaced normalised Gaussians of variance `delta_sq` at alpha*n."""
    s = torch.as_tensor(s)
    return theta3(s / alpha, 2j * math.pi * delta_sq / alpha**2, terms=terms) / alpha
