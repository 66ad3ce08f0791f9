"""[n,1,n] repetition-code error-detection evaluator.

Parity with reference ``ConstantRateDistillation/Distillation_functions.py``:
symbolic logical-Pauli probability expressions (sympy, vendored pickles in
``code_data/``) evaluated at mpmath precision, with X/Y basis changes via
H / HSH conjugation permutations.

The pickled expressions are DATA from the reference's own vendored
ConstantRateDistillation project (arXiv companion data); they are loaded
lazily and cached per n.
"""

from __future__ import annotations

import os
import pickle
from functools import lru_cache

import mpmath

_DIR = os.path.join(os.path.dirname(os.path.realpath(__file__)), "code_data")
MAX_REP_CODE = 12


@lru_cache(maxsize=None)
def _prob_dict(n: int) -> dict:
    path = os.path.join(_DIR, f"repetition_code_prob_dict__n_{n}.pkl")
    with open(path, "rb") as fh:
        return pickle.load(fh)


def depolarizing(p) -> list:
    """Scalar error -> Pauli probability vector [pI, pX, pZ, pY]."""
    if isinstance(p, mpmath.mpf):
        return [mpmath.mpf(1) - p, p / 3, p / 3, p / 3]
    if isinstance(p, list):
        if len(p) == 1:
            q = p[0]
            return [mpmath.mpf(1) - q, q / 3, q / 3, q / 3]
        if len(p) > 1:
            return p
    raise ValueError("Invalid input. Expected an mpf number or a list.")


def hadamard(p) -> list:
    """I,X,Z,Y -> I,Z,X,Y (conjugation by H)."""
    return [p[0], p[2], p[1], p[3]]


def s_mat(p) -> list:
    """I,X,Z,Y -> I,Y,Z,X (conjugation by HSH)."""
    return [p[0], p[3], p[2], p[1]]


def ED_C_n_1_n(n: int, p: list) -> tuple:
    """Evaluate the [n,1,n] repetition code in the Z basis.

    Returns (acceptance rate per input qubit, normalised output Pauli vector).
    """
    exprs = _prob_dict(n)
    subs = {
        "pI": mpmath.mpf(p[0]), "pX": mpmath.mpf(p[1]),
        "pZ": mpmath.mpf(p[2]), "pY": mpmath.mpf(p[3]),
    }
    LpI = exprs["IL"].subs(subs)
    LpX = exprs["XL"].subs(subs)
    LpZ = exprs["ZL"].subs(subs)
    LpY = exprs["YL"].subs(subs)
    norm = LpI + LpX + LpZ + LpY
    p_reject = mpmath.mpf(1) - norm
    rate = (mpmath.mpf(1) - p_reject) / mpmath.mpf(n)
    return rate, [LpI / norm, LpX / norm, LpZ / norm, LpY / norm]


def ED_n_1_n(n: int, in_error, basis: str = "Z"):
    """Repetition-code error detection in basis Z/X/Y.

    Returns (effective rate, output Pauli error vector, output qubit count).
    """
    if basis == "X":
        in_error = hadamard(depolarizing(in_error))
    elif basis == "Y":
        in_error = hadamard(s_mat(hadamard(depolarizing(in_error))))

    eff_rate, out_error = ED_C_n_1_n(n, depolarizing(in_error))

    if basis == "X":
        out_error = hadamard(out_error)
    elif basis == "Y":
        out_error = hadamard(s_mat(hadamard(out_error)))
    return eff_rate, out_error, 1
