"""Post-processing of pipeline result datasets (counterpart of
``quantum_computations_tpu/pipelines/analysis.py``, a numpy/scipy copy):
randomised-benchmarking decay fits (a p^m + 1/4), Grover success
probabilities from the stored logical density matrices, the analytic
Walshe-style estimates and Clifford-average summaries, as plain functions
over the ``.dat`` JSON schemas.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np
from scipy.optimize import curve_fit


def load_dat(path: str) -> list[dict]:
    with open(path) as fh:
        return json.load(fh)


# -- randomised benchmarking -------------------------------------------------

def rb_decay_model(m, a, p):
    """Two-qubit RB decay toward the fully-mixed plateau 1/4."""
    return a * p**m + 0.25


def rb_fit(samples: list[dict]) -> dict:
    """Group samples by dB, fit fidelity(depth) = a p^depth + 1/4 per group.

    Returns {db: {"a", "p", "depths", "mean_fidelity", "mean_purity"}}.
    """
    by_db = defaultdict(list)
    for s in samples:
        by_db[float(s["db"])].append(s)

    out = {}
    for db, group in sorted(by_db.items()):
        by_depth = defaultdict(list)
        purities = defaultdict(list)
        for s in group:
            by_depth[int(s["depth"])].append(float(s["fidelity"]))
            purities[int(s["depth"])].append(float(s["purity"]))
        depths = np.array(sorted(by_depth))
        means = np.array([np.mean(by_depth[d]) for d in depths])
        (a, p), _ = curve_fit(rb_decay_model, depths, means, p0=[0.75, 0.9],
                              bounds=([0, 0], [1.5, 1]), maxfev=10000)
        out[db] = {
            "a": float(a), "p": float(p),
            "depths": depths.tolist(),
            "mean_fidelity": means.tolist(),
            "mean_purity": [float(np.mean(purities[d])) for d in depths],
        }
    return out


# -- Grover ------------------------------------------------------------------

def grover_rho(entry: dict) -> np.ndarray:
    return np.array(entry["rho_real"]) + 1j * np.array(entry["rho_imag"])


def grover_success(entry: dict, tagged: list[int]) -> float:
    """Success probability = sum of tagged RAW diagonal entries (reference
    plot_data.ipynb cell 11 applies no trace normalisation)."""
    rho = grover_rho(entry)
    return float(np.sum(np.diag(rho).real[list(tagged)]))


def grover_success_by_db(data: list[dict], tagged: list[int]) -> dict[float, float]:
    """Mean success per squeezing level (keyed by dB, from stored epsilon)."""
    from ..gkp import eps2db

    by_db = defaultdict(list)
    for entry in data:
        db = round(float(eps2db(entry["epsilon"])), 6)
        by_db[db].append(grover_success(entry, tagged))
    return {db: float(np.mean(v)) for db, v in sorted(by_db.items())}


def grover_success_curve(data: list[dict], tagged: list[int]) -> dict:
    """Success-vs-dB curve exactly as reference plot_data.ipynb cell 11-12:
    per-dB mean with a 2*SE errorbar (the notebook's ``errs``), keyed by dB
    rounded to the reference sweep grid (3 decimals)."""
    from ..gkp import eps2db

    by_db = defaultdict(list)
    for entry in data:
        db = round(float(eps2db(entry["epsilon"])), 3)
        by_db[db].append(grover_success(entry, tagged))
    return {db: {"mean": float(np.mean(v)),
                 "err_2se": float(2 * np.std(v) / np.sqrt(len(v))),
                 "n": len(v)}
            for db, v in sorted(by_db.items())}


def analytical_gate_error(db: float, integer: int) -> float:
    """Per-quadrature MB gate-error estimate (Walshe et al. 2022), as in
    reference plot_data.ipynb cell 2: input quadrature variance
    ``integer * eps / 2`` -> erf success rate per quadrature."""
    from scipy.special import erf

    from ..gkp import db2eps

    var = integer * float(db2eps(db)) / 2
    return float(1 - erf(np.sqrt(np.pi / (8 * var))))


def grover_error_estimate(db: float, *, n_qubits: int = 3, k_solutions: int = 2,
                          depth: int = 18) -> float:
    """Analytic Grover success estimate drawn on the reference's combined
    plot (plot_data.ipynb cell 2 ``grover_with_error_estimate``): average
    the I- and P-gadget error rates, compound over depth*N gates, and mix
    the failed fraction uniformly over the 2^N outcomes."""
    e2 = analytical_gate_error(db, 2)
    e3 = analytical_gate_error(db, 3)
    err_i = 1 - (1 - e2) * (1 - e2)
    err_p = 1 - (1 - e2) * (1 - e3)
    r = (err_i + err_p) / 2
    p_no_err = (1 - 4 / 3 * r) ** (depth * n_qubits)
    return float(p_no_err + k_solutions / 2 ** n_qubits * (1 - p_no_err))


# -- Clifford-encoding fidelity ----------------------------------------------

def clifford_summary(data: list[dict]) -> dict:
    """Per-dB mean Pauli fidelity over classes (the 1/4 invariant) and the
    per-class identity-Pauli encoding fidelity."""
    by_db = defaultdict(list)
    for entry in data:
        by_db[float(entry["db"])].append(entry)
    out = {}
    for db, entries in sorted(by_db.items()):
        all_fids = np.array([e["fidelities"] for e in entries])
        out[db] = {
            "mean_over_paulis": float(all_fids.mean()),
            "mean_identity_fidelity": float(all_fids[:, 0].mean()),
            "num_classes": len(entries),
        }
    return out
