"""CV mode states on the position grid (counterpart of
``quantum_computations_tpu/cv/states.py``).

Named states, analytic wavefunctions and finite-energy GKP states through
the truncated theta series of :mod:`..ops.theta`. Every wavefunction is
formed in float64/complex128 on the grid's device; :meth:`State.eval`
normalises it on the grid and casts it to the state's dtype last.
"""

from __future__ import annotations

import math
from enum import Enum, auto

import numpy as np
import torch

from ..config import complex_dtype, resolve_device
from ..ops.theta import modified_theta

PI = math.pi
SQPI = math.sqrt(math.pi)


def _m(x):
    """The math module for a host scalar, torch for a tensor: scalars stay
    on the host, so forming a state never waits for the device."""
    return torch if isinstance(x, torch.Tensor) else math


def _grid(q) -> torch.Tensor:
    q = torch.as_tensor(q)
    return q if q.is_complex() else q.to(torch.float64)


# ---------------------------------------------------------------------------
# Analytic wavefunctions (q a float64 tensor)
# ---------------------------------------------------------------------------

def rotated_eigenstate(q, x, theta):
    q = _grid(q)
    m = _m(theta)
    return (2 * PI * abs(m.sin(theta))) ** -0.5 * torch.exp(
        -1j * (m.cos(theta) * (q * q + x * x) / 2 - x * q) / m.sin(theta)
    )


def momentum_eigenstate(q, p):
    q = _grid(q)
    return torch.exp(-1j * q * p) / SQPI


def _delta_theta(delta, theta):
    m = _m(theta)
    return ((m.cos(theta) * delta) ** 2 + (m.sin(theta) / delta) ** 2) ** 0.5


def squeezed_coherent(q, alpha, r, theta):
    q = _grid(q)
    alpha = complex(alpha)
    mr, mt = _m(r), _m(theta)
    d = _delta_theta(mr.exp(r), theta)
    return (PI * d**2) ** (-1 / 4) * torch.exp(
        -0.5 * ((q - alpha.real) / d) ** 2 * (1 - 1j * mr.sinh(2 * r) * mt.sin(2 * theta))
        + 1j * alpha.imag * q
    )


def vacuum(q):
    return squeezed_coherent(q, 0.0, 0.0, 0.0)


def coherent(q, alpha):
    return squeezed_coherent(q, alpha, 0.0, 0.0)


def squeezed_vac(q, r):
    return squeezed_coherent(q, 0.0, r, 0.0)


def fock_state(q, n: int):
    """n-th Fock state via the Hermite recurrence."""
    q = _grid(q)
    h_prev = torch.ones_like(q)
    h = 2 * q
    if n == 0:
        h = h_prev
    else:
        for k in range(1, n):
            h, h_prev = 2 * q * h - 2 * k * h_prev, h
    return h * torch.exp(-(q**2) / 2) * (2**n * float(math.factorial(n)) * SQPI) ** -0.5


# ---------------------------------------------------------------------------
# GKP states (Matsuura et al. symmetric approximation)
# ---------------------------------------------------------------------------

def gkp(q, kappa, delta, state=(1, 0)):
    q = _grid(q)
    env = torch.exp(-(q**2) / 2 / ((1 + delta**2 * kappa**2) / kappa**2))
    tau = 0.5j * delta**2 / (1 + kappa**2 * delta**2)
    tot = 0.0
    for mu, c in enumerate(state):
        tot = tot + complex(c) * modified_theta(0, mu / 2, -q / (2 * SQPI * (1 + kappa**2 * delta**2)), tau)
    return env * tot


def gkp_sym(q, epsilon, state=(1, 0)):
    q = _grid(q)
    m = _m(epsilon)
    env = torch.exp(-m.tanh(epsilon) * q**2 / 2)
    tau = 1j * m.tanh(epsilon) / 2
    tot = 0.0
    for mu, c in enumerate(state):
        tot = tot + complex(c) * modified_theta(0, mu / 2, -q / (2 * SQPI * m.cosh(epsilon)), tau)
    return env * tot


def comb(q, kappa, delta, alpha):
    q = _grid(q)
    env = torch.exp(-(q**2) / 2 / ((1 + delta**2 * kappa**2) / kappa**2))
    return env * modified_theta(
        0, 0, -q / (alpha * (1 + kappa**2 * delta**2)), 1j * delta**2 / (1 + kappa**2 * delta**2)
    )


def comb_sym(q, epsilon, alpha):
    q = _grid(q)
    m = _m(epsilon)
    env = torch.exp(-m.tanh(epsilon) * q**2 / 2)
    return env * modified_theta(0, 0, -q / (alpha * m.cosh(epsilon)), 1j * m.tanh(epsilon))


def qunaught(q, epsilon):
    return comb_sym(q, epsilon, math.sqrt(2 * PI))


def _grid_normalise(qs, result):
    dq = torch.abs(qs[-1] - qs[0]) / (qs.shape[0] - 1)
    norm_sq = torch.sum(result * torch.conj(result)).real * dq
    return result / torch.sqrt(norm_sq)


def _eval_grid(qs, device) -> torch.Tensor:
    """The grid as a float64 tensor: a tensor stays on its device, a numpy
    array is validated and goes to ``device`` (default ``cuda``)."""
    if isinstance(qs, torch.Tensor):
        return qs.to(torch.float64)
    qs = np.asarray(qs)
    if qs.ndim != 1:
        raise TypeError("qs must be a 1D array.")
    if not np.allclose(np.diff(qs, 2), 0, atol=np.finfo(qs.dtype).eps**0.5):
        raise ValueError("qs is not an arithmetic progression.")
    return torch.as_tensor(qs, dtype=torch.float64, device=resolve_device(device))


def eval_gkp_state(qs, epsilon, coefficients, *, device=None, dtype=None) -> torch.Tensor:
    """Grid-normalised finite-energy GKP state with logical coefficients."""
    qs = _eval_grid(qs, device)
    dtype = dtype or complex_dtype(qs.device)
    return _grid_normalise(qs, gkp_sym(qs, epsilon, coefficients)).to(dtype)


class State(Enum):
    GKP_ZERO = auto()
    GKP_ONE = auto()
    GKP_PLUS = auto()
    GKP_MINUS = auto()
    GKP_T = auto()
    GKP_TDG = auto()
    GKP_H = auto()
    VACUUM = auto()
    QUNAUGHT = auto()

    def __repr__(self):
        return self.name

    def __str__(self):
        return self.name

    def gkp_coefficients(self):
        match self:
            case State.GKP_ZERO:
                return (1, 0)
            case State.GKP_ONE:
                return (0, 1)
            case State.GKP_PLUS:
                return (1, 1)
            case State.GKP_MINUS:
                return (1, -1)
            case State.GKP_T:
                return (1, np.exp(1j * PI / 4))
            case State.GKP_TDG:
                return (1, np.exp(-1j * PI / 4))
            case State.GKP_H:
                return (np.cos(PI / 8), np.sin(PI / 8))
            case _:
                return None

    def eval(self, qs, gkp_epsilon: float | None = None, *, device=None,
             dtype=None) -> torch.Tensor:
        """Grid-normalised wavefunction of this state on `qs`.

        ``qs`` is a numpy grid (validated, then put on ``device``, default
        ``cuda``) or a tensor (its device). ``dtype`` defaults to
        :func:`..config.complex_dtype` of that device.
        """
        if gkp_epsilon is not None and not isinstance(gkp_epsilon, torch.Tensor) and gkp_epsilon <= 0:
            raise ValueError("epsilon must be a positive real number")
        qs = _eval_grid(qs, device)
        dtype = dtype or complex_dtype(qs.device)

        coeffs = self.gkp_coefficients()
        if coeffs is not None:
            if gkp_epsilon is None:
                raise ValueError("Evaluating gkp states require a gkp_epsilon.")
            result = gkp_sym(qs, gkp_epsilon, coeffs)
        elif self is State.VACUUM:
            result = vacuum(qs)
        elif self is State.QUNAUGHT:
            if gkp_epsilon is None:
                raise ValueError("Evaluating qunaught states require a gkp_epsilon.")
            result = comb_sym(qs, gkp_epsilon, math.sqrt(2 * PI))
        else:
            raise NotImplementedError(self)

        return _grid_normalise(qs, result).to(dtype)
