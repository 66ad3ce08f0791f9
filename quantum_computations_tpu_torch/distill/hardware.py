"""Hardware error/rate models for modular surface-code architectures.

Capability parity with reference ``fault-tolerant_.../utils.py`` (fractional
depolarisation :9-47, balanced depolarisation :50-72, surface-code qubit
counts :75-82, Ramette et al. bulk+seam logical error :99-134, power-law
error/size :138-153, ``find_code_size`` :156-199, transversal /
lattice-surgery rate models :206-237, bisection :240-264). The published
formulas and fitted constants are load-bearing and appear verbatim; the
implementation is reorganised around one algebraic redesign:

Any Pauli channel's 4x4 mixing matrix ``M[g, h] = p_{g.h}`` is the group
convolution operator of the Klein four-group {I, X, Y, Z}, so its eigenbasis
is the (real) character table and its eigenvalues are the Walsh-Hadamard
transform of the probability vector — exactly. Both
:class:`DepolarisationChannel` (the reference diagonalises numerically with
``mpmath.eigh``) and :func:`balanced_depolarisation_noise` reduce to the same
closed form :func:`pauli_channel_power`, with no iterative eigensolver.

Precision: dps=80 is pinned as the superset of the reference's precisions.
The reference's effective dps is import-order dependent (mpmath precision is
process-global, last setter wins): the parallel search scripts end at 80 via
``Distillation_functions.py:5``, while ``physical_distillation.py``'s import
chain (and its ``__main__``) ends at ``utils.py``'s 24. Both exceed float64,
so the numbers are unaffected; 80 covers every driver.
"""

from __future__ import annotations

from math import ceil, log2
from typing import Callable

import mpmath
from mpmath import mpf

mpmath.mp.dps = 80

# ---------------------------------------------------------------------------
# Pauli-channel algebra (Klein four-group harmonic analysis)
# ---------------------------------------------------------------------------

# Character table of Z2 x Z2, columns ordered (I, X, Y, Z). Symmetric,
# involutory up to 1/4: CHI @ CHI = 4 * Identity.
_CHI = mpmath.matrix([
    [1, 1, 1, 1],
    [1, 1, -1, -1],
    [1, -1, 1, -1],
    [1, -1, -1, 1],
])


def as_pauli_probs(error) -> list:
    """Normalise scalar / 3-vector / 4-vector error input to [pI, pX, pY, pZ]."""
    if isinstance(error, (float, int, mpf)):
        return [1 - error, error / 3, error / 3, error / 3]
    if len(error) == 3:
        return [1 - sum(error), *error]
    if len(error) == 4:
        return list(error)
    raise ValueError("Unknown error type!")


def pauli_channel_power(p_vec: list, exponent) -> list:
    """Apply ``exponent`` (possibly fractional) rounds of the Pauli channel
    with single-round probabilities ``p_vec`` to a delta input — i.e. the
    first column of M^exponent. Exact spectral form:
    eigenvalues are the WHT of p_vec; eigenvectors the characters."""
    lams = _CHI * mpmath.matrix(p_vec)
    powered = mpmath.matrix(
        [mpmath.power(lams[i], exponent) for i in range(4)])
    return [sum(_CHI[g, c] * powered[c] for c in range(4)) / 4 for g in range(4)]


def _mix(p_vec: list, weights: list) -> list:
    """One application of the channel with probabilities ``p_vec`` to an
    input Pauli distribution ``weights``: group convolution via WHT."""
    lam_p = _CHI * mpmath.matrix(p_vec)
    lam_w = _CHI * mpmath.matrix(weights)
    prod = mpmath.matrix([lam_p[i] * lam_w[i] for i in range(4)])
    return [sum(_CHI[g, c] * prod[c] for c in range(4)) / 4 for g in range(4)]


class DepolarisationChannel:
    """Continuous-time depolarisation: fractional applications by raising the
    channel's WHT eigenvalues to ``rate * time`` (reference utils.py:9-47
    does the same via a numerical ``mpmath.eigh``; here the spectrum is the
    exact character transform)."""

    def __init__(self, error, error_rate: float = 1.0):
        self.p_vec = as_pauli_probs(error)
        self.rate = mpf(error_rate)

    # Retained as a method for reference-parity call sites.
    @staticmethod
    def to_error_vec(error) -> list:
        return as_pauli_probs(error)

    def apply(self, in_error, time, output_scalar: bool = False):
        stepped = pauli_channel_power(self.p_vec, self.rate * mpf(time))
        out = _mix(stepped, as_pauli_probs(in_error))
        return sum(out[1:]) if output_scalar else out


def balanced_depolarisation_noise(error: list, p, depth) -> list:
    """``depth`` rounds of balanced depolarisation of strength ``p`` applied
    to the Pauli distribution ``error`` (reference utils.py:50-72)."""
    stepped = pauli_channel_power(as_pauli_probs(mpf(p)), depth)
    return _mix(stepped, error)


# ---------------------------------------------------------------------------
# Surface-code sizes and logical error rates
# ---------------------------------------------------------------------------

# Fitted constants shared by the error models:
# - power-law patch model: coefficient and bulk threshold (Fowler-style fit
#   used by the reference, utils.py:138-144)
# - bulk+seam model: Ramette et al. 2024 eq. 4 supplementary numerics
#   (utils.py:99-134).
_COEFF = mpf("8e-2")
_P_BULK_STAR = mpf("0.75e-2")
_P_SEAM_STAR = mpf("10.4e-2")
_ALPHA_C = mpf("1.4")
_A_BULK = 8e-2
_A_SEAM = 0.15429674683914762
_A_CROSS = 0.0104242833132694


def surface_code_qubits(L: int, total: bool = True, *, rotated: bool = True):
    """Qubit count of an L x L surface-code patch; ``total=False`` returns
    the (data, ancilla) split."""
    if rotated:
        counts = (L ** 2, L ** 2 - 1)
    else:
        counts = (L ** 2 + (L - 1) ** 2, 2 * L * (L - 1))
    return sum(counts) if total else counts


def surface_code_error(L: int, p_local):
    """Power-law logical error of a distance-L patch (no seam)."""
    return _COEFF * (p_local / _P_BULK_STAR) ** (L / 2)


def surface_code_size(p_local, p_logical) -> int:
    """Smallest L meeting ``p_logical`` under the power-law model."""
    return ceil(2 * log2(p_logical / _COEFF) / log2(p_local / _P_BULK_STAR))


def logical_error_rate_bulk_seam(L: int, p_b, p_s):
    """Bulk+seam logical error rate (Ramette et al. 2024, eq. 4 numerics)."""
    p_star_1s = _P_SEAM_STAR / (
        1 + _ALPHA_C * p_b * _P_SEAM_STAR ** 0.5 / (1 - (p_b / _P_BULK_STAR) ** 0.5)
    ) ** 2
    seam_term = _A_SEAM * (p_s / _P_SEAM_STAR) ** (L / 2)
    bulk_term = _A_BULK * (p_b / _P_BULK_STAR) ** (L / 2)
    cross_term = _A_CROSS * sum(
        (p_s / p_star_1s) ** (gs / 2) * (p_b / _P_BULK_STAR) ** ((L - gs) / 2)
        for gs in range(1, L + 1)
    )
    return seam_term + bulk_term + cross_term


def find_code_size(
    code_error: Callable[..., float],
    p_target,
    args: tuple = (),
    stepsize: int = 100,
    always_return: bool = False,
) -> tuple[int, float]:
    """Smallest L with ``code_error(L) < p_target``.

    Three phases (``code_error`` need not be monotone near threshold):
    coarse upward walk until the target is crossed or the error stops
    improving, ternary search for the minimum of |target - error| inside the
    last step, then a brute-force scan of the surviving <=4-wide window.
    """
    # phase 1: coarse walk
    upper, prev = 1, 1
    while True:
        err = code_error(upper, *args)
        if err < p_target or err > prev:
            break
        prev = err
        upper += stepsize

    # phase 2: ternary search on the gap
    gap = lambda L: abs(p_target - code_error(L, *args))
    lo, hi = upper - stepsize, upper
    while hi - lo > 3:
        third = (hi - lo) // 3
        if gap(lo + third) < gap(hi - third):
            hi = hi - third
        else:
            lo = lo + third

    # phase 3: exact scan
    window = [(L, code_error(L, *args)) for L in range(lo, hi + 1)]
    for L, err in window:
        if err < p_target:
            return L, err
    if always_return:
        return min(window, key=lambda pair: pair[1])
    raise ValueError("No solution exists!")


def surface_code_size_bulk_seam(p_bulk, p_seam, p_logical) -> int:
    return find_code_size(logical_error_rate_bulk_seam, p_logical,
                          args=(p_bulk, p_seam))[0]


# ---------------------------------------------------------------------------
# Inter-module gate rate models (reference utils.py:206-237)
# ---------------------------------------------------------------------------

def transversal_gate_rate(L: int, r_physical, r_bell, memory: int):
    """Transversal inter-module gate rate: the minimum of the Bell-pair
    preparation rate and the memory-limited consumption rate."""
    n_data, n_anc = surface_code_qubits(L, False, rotated=False)
    patch = n_data + n_anc
    concurrent = memory // (n_data + patch)
    prepare = r_bell / n_data
    consume = (r_physical / 5) * concurrent
    return min(prepare, consume)


def lattice_surgery_gate_rate(L: int, r_physical, r_bell, memory: int):
    """Lattice-surgery inter-module gate rate; the merge runs L rounds over
    an L-qubit seam."""
    n_data, n_anc = surface_code_qubits(L, False, rotated=False)
    patch = n_data + n_anc
    concurrent = memory // (L + patch)
    prepare = r_bell / (L * L)
    consume = concurrent * (r_physical / 5) / L
    return min(prepare, consume)


def find_root_bisection(f, a, b, reltol=mpf("1e-6"), maxiter: int = 1000):
    """Bisection with relative-x termination (reference utils.py:240-264)."""
    fa = f(a)
    if fa * f(b) > 0:
        raise ValueError("Function must change sign over the interval [a, b].")
    for _ in range(maxiter):
        mid = (a + b) / 2
        if abs((b - a) / mid) < reltol:
            return mid
        fmid = f(mid)
        if fa * fmid < 0:
            b = mid
        else:
            a, fa = mid, fmid
    raise RuntimeError("Maximum iterations exceeded without reaching relative tolerance.")
