"""GKP error-correction validation suite (counterpart of
``quantum_computations_tpu/pipelines/gkp_ec_validation.py``).

The second paper's numerical tests and figure experiments as runnable
code, with the port's grid kernels as the fast path and analytic formulas
as the oracle:

- :func:`gaussian_product_identity_check` — Monte-Carlo check of the
  Gaussian-product identity (numpy only);
- :func:`steane_ec_width_test` — Steane-type EC on a finite-energy GKP
  state, the output widths fitted (scipy's ``curve_fit`` on the host in
  float64) against eps_ancilla (1 + 2x) / (1 + x) (q) and
  eps_ancilla (1 + x) / (2 + x) (p);
- :func:`knill_steane_equivalence_check` — Knill and Steane EC on the same
  coherent input with the same post-selected homodyne results: the output
  Wigner functions and the overlap;
- :func:`imperfect_p_gate_experiment`, :func:`imperfect_cx_gate_experiment`
  — perfect CV gates implement imperfect logical gates, and the symmetric
  GKP projector restores the logical fidelity;
- :func:`bell_state_comparison` — qunaught states through a beamsplitter
  against GKP states through CX.

Every experiment takes ``device`` (default ``cuda``) and runs in the
device's complex dtype (``config.complex_dtype``); grid functions are
formed in float64 and cast to it. Grid conventions are the reference's
(see :mod:`.gkp_ec`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import curve_fit

from ..config import complex_dtype, resolve_device
from ..cv.states import coherent, comb_sym
from ..ops.interp import (
    CFT, fourier as fourier_gate, rotation_maps, shear_maps, warp_2d,
    whittaker_shannon, wigner,
)
from .gkp_ec import fourier, gkp_project_asym, gkp_project_sym, gkp_sym, \
    logical_fidelity, normalise


def gaussian_product_identity_check(samples: int = 100, seed: int = 1,
                                    grid_points: int = 1000) -> int:
    """Check the 1D x 2D Gaussian integral identity on random cases.

    Returns the number of failed cases (0 expected).
    """
    def G1(q, mu, Q):
        return np.exp(-(q - mu) ** 2 / 2 * Q)

    def G2(q, mu, Q):
        return np.exp(
            -((q[0] - mu[0]) ** 2 * Q[0, 0] + (q[1] - mu[1]) ** 2 * Q[1, 1]
              + 2 * (q[0] - mu[0]) * (q[1] - mu[1]) * Q[0, 1]) / 2
        )

    qs = np.linspace(-10, 10, grid_points)
    rng = np.random.default_rng(seed)
    failed = 0
    for _ in range(samples):
        mu = (rng.random() - 0.5) * 6
        q = 1 / (rng.random() * 2)
        mu_vec = (rng.random(2) - 0.5) * 6
        Q = np.diag(1 / (rng.random(2) * 2))
        theta = rng.random() * 2 * np.pi
        O = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
        Q = O.T @ Q @ O

        g1 = G1(qs, mu, q)
        g2 = G2(np.meshgrid(qs, qs, indexing="ij"), mu_vec, Q)
        integrand = np.einsum("i,ij->ij", g1, g2)
        I_numeric = np.trapezoid(integrand, qs, axis=0) / np.sqrt(2 * np.pi)

        detQ = np.linalg.det(Q)
        n = np.sqrt(q + Q[0, 0])
        rho_sqrd = 1 / q + Q[1, 1] / detQ
        nu = mu_vec[1] + q * Q[0, 1] / (detQ + q * Q[1, 1]) * (mu_vec[0] - mu)
        sigma_sqrd = (Q[0, 0] + q) / (detQ + q * Q[1, 1])
        I_analytic = (
            1 / n * G1(mu_vec[0] - mu, 0, 1 / rho_sqrd) * G1(qs, nu, 1 / sigma_sqrd)
        )
        if not np.allclose(I_numeric, I_analytic):
            failed += 1
    return failed


def _gaussian(x, mu, sigma):
    return np.exp(-((x - mu) ** 2) / (2 * sigma**2)) / (np.sqrt(2 * np.pi) * sigma)


def _sum_of_gaussians(x, *params):
    n = len(params) // 2
    a, sigma = params[:n], params[n:]
    mu = (np.arange(n) - (n - 1) // 2) * np.sqrt(np.pi)
    y = np.zeros_like(x)
    for i in range(n):
        y += a[i] * _gaussian(x, mu[i], sigma[i])
    return y


def fit_lattice_gaussians(qs: np.ndarray, amplitude, n_gaussians: int = 9,
                          sigma0: float = 0.3) -> float:
    """Fit |psi| as a sum of Gaussians on the sqrt(pi) lattice (host
    float64); returns the weight-filtered mean squared width."""
    if isinstance(amplitude, torch.Tensor):
        amplitude = amplitude.cpu().numpy()
    p0 = np.hstack([np.ones(n_gaussians), np.ones(n_gaussians) * sigma0])
    popt, _ = curve_fit(_sum_of_gaussians, np.asarray(qs, np.float64),
                        np.abs(amplitude).astype(np.float64), p0=p0, maxfev=20000)
    weights, sigmas = popt[:n_gaussians], popt[n_gaussians:]
    filtered = [s for s, w in zip(sigmas, weights) if w > 0.05]
    return float(np.mean(filtered) ** 2)


def _grid(lo: float, hi: float, n: int, device) -> tuple[np.ndarray, torch.Tensor]:
    """The grid on the host and, in float64, on the device."""
    qs = np.linspace(lo, hi, n)
    return qs, torch.as_tensor(qs, dtype=torch.float64, device=device)


def _gkp(qs: torch.Tensor, epsilon: float, state) -> torch.Tensor:
    """The normalised symmetric GKP state in the grid device's complex dtype."""
    return normalise(qs, gkp_sym(qs, epsilon, state).to(complex_dtype(qs.device)))


def steane_ec_width_test(epsilon_in: float = 0.1, epsilon_ancilla: float = 0.08,
                         grid_points: int = 1000, device=None) -> dict:
    """Steane-type EC on a GKP |H> state; returns numerical vs analytic widths.

    Analytic output widths (reference cell 7):
      q: eps_ancilla * (1 + 2x) / (1 + x),  x = eps_in / eps_ancilla
      p: eps_ancilla * (1 + x) / (2 + x)
    """
    qs, tqs = _grid(-20, 20, grid_points, resolve_device(device))
    zero = _gkp(tqs, epsilon_ancilla, (1, 0))
    state_in = _gkp(tqs, epsilon_in, (np.cos(np.pi / 8), np.sin(np.pi / 8)))
    state_q = normalise(tqs, gkp_project_asym(tqs, state_in, zero))
    state_p = fourier(tqs, state_q)

    x = epsilon_in / epsilon_ancilla
    return {
        "epsilon_in": epsilon_in,
        "epsilon_ancilla": epsilon_ancilla,
        "analytic_q": epsilon_ancilla * (1 + 2 * x) / (1 + x),
        "analytic_p": epsilon_ancilla * (1 + x) / (2 + x),
        "numeric_q": fit_lattice_gaussians(qs, state_q, sigma0=epsilon_ancilla**0.5),
        "numeric_p": fit_lattice_gaussians(qs, state_p, sigma0=epsilon_ancilla**0.5),
    }


# ---------------------------------------------------------------------------
# figures.ipynb experiments
# ---------------------------------------------------------------------------

def knill_steane_equivalence_check(epsilon: float = 0.095,
                                   grid_points: int = 900,
                                   s_q: float | None = None,
                                   s_p: float | None = None,
                                   displacement: complex | None = None,
                                   device=None) -> dict:
    """Steane EC is a special case of Knill EC (figures.ipynb cells 2-5).

    Runs both circuits on the same coherent input with the same
    post-selected homodyne results and returns the max |Wigner difference|
    of the outputs (and relative to the Wigner peak) plus the wavefunction
    overlap.

    Knill: input (x) GKP0 (x) GKP0; R(pi/2) on the first ancilla; CX(+1)
    anc1->anc2; CX(-1) anc1->input; measure q(input)=s_q, p(anc1)=s_p;
    output = anc2. Post-selection reduces this exactly on the grid:
    T(x1,x2) = F[anc](x1) anc(x2-x1), rows scaled by psi_in(s_q+x1), then
    a CFT slice at p=s_p; ``gkp_sym`` is evaluated on the flattened d^2
    grid of x2 - x1.

    Steane: CZ(input,anc1); R(-pi/2); CZ(input,anc2'=R(pi)anc2); R(pi/2);
    p-measurements s_q/s_p on the ancillas; displacement by -(s_q + i s_p).
    Each post-selected CZ+p-measurement multiplies by CFT[anc](s - x).
    """
    SQPI = np.sqrt(np.pi)
    s_q = 0.4 * SQPI if s_q is None else s_q
    s_p = 0.1 * SQPI if s_p is None else s_p
    d = (1.8 + 0.5j) * SQPI if displacement is None else displacement

    _, qs = _grid(-18, 18, grid_points, resolve_device(device))
    cdt = complex_dtype(qs.device)
    dq = (18 - (-18)) / (grid_points - 1)
    psi_in = coherent(qs, d).to(cdt)  # mean x = Re d, mean p = Im d (hbar = 1)
    anc = _gkp(qs, epsilon, (1, 0))

    # -- Knill --------------------------------------------------------------
    ancR = fourier_gate(qs, anc)
    X1, X2 = torch.meshgrid(qs, qs, indexing="ij")
    nrm = 1.0 / torch.sqrt(torch.trapezoid(torch.abs(gkp_sym(qs, epsilon, (1, 0))) ** 2, qs))
    anc_shift = (nrm * gkp_sym((X2 - X1).reshape(-1), epsilon, (1, 0))
                 ).reshape(X1.shape).to(cdt)
    T = ancR[:, None] * anc_shift
    phi = coherent(s_q + qs, d).to(cdt)[:, None] * T
    out_knill = normalise(qs, torch.sum(
        torch.exp(-1j * s_p * qs).to(cdt)[:, None] * phi, dim=0) * dq / np.sqrt(2 * np.pi))

    # -- Steane -------------------------------------------------------------
    ps, anc_hat = CFT(qs, anc)
    f1 = whittaker_shannon(ps, anc_hat, s_q - qs)
    ps2, anc2_hat = CFT(qs, torch.flip(anc, (0,)))  # R(pi) = parity on the second ancilla
    f2 = whittaker_shannon(ps2, anc2_hat, s_p - qs)
    psi = fourier_gate(qs, psi_in * f1, inv=True) * f2
    psi = fourier_gate(qs, psi)
    psi = whittaker_shannon(qs, psi, qs + s_q) * torch.exp(-1j * s_p * qs).to(cdt)
    out_steane = normalise(qs, psi)

    window = torch.linspace(-3 * SQPI, 3 * SQPI, 80, dtype=torch.float64, device=qs.device)
    _, Wk = wigner(window, whittaker_shannon(qs, out_knill, window))
    _, Ws = wigner(window, whittaker_shannon(qs, out_steane, window))
    diff = torch.abs(Wk - Ws).max()
    overlap = torch.abs(torch.trapezoid(torch.conj(out_knill) * out_steane, qs))
    return {
        "max_wigner_diff": float(diff),
        "rel_wigner_diff": float(diff / torch.abs(Wk).max()),
        "overlap": float(overlap),
    }


def imperfect_p_gate_experiment(epsilon: float = 0.1, grid_points: int = 700,
                                device=None) -> dict:
    """Perfect CV P-gate on |+>_gkp implements an imperfect logical gate;
    the symmetric GKP projector restores the logical fidelity
    (figures.ipynb cell 9). Returns fidelity at the three checkpoints."""
    _, qs = _grid(-15, 15, grid_points, resolve_device(device))
    plus = _gkp(qs, epsilon, (1, 1))
    zero = _gkp(qs, epsilon, (1, 0))
    one = _gkp(qs, epsilon, (0, 1))
    f_init = logical_fidelity(qs, plus)
    sheared = plus * torch.exp(0.5j * qs ** 2).to(plus.dtype)
    f_gate = logical_fidelity(qs, sheared)
    projected = normalise(qs, gkp_project_sym(qs, sheared, zero, one))
    f_proj = logical_fidelity(qs, projected)
    return {"initial": f_init, "after_gate": f_gate, "after_projection": f_proj}


def imperfect_cx_gate_experiment(epsilon: float = 0.15, grid_points: int = 500,
                                 device=None) -> dict:
    """Two-mode analogue with a CX controlled displacement on |+>|+>
    (figures.ipynb cell 10), ``warp_2d`` on a (1, d, d, 1) view."""
    _, qs = _grid(-15, 15, grid_points, resolve_device(device))
    dq = (15 - (-15)) / (grid_points - 1)
    plus = _gkp(qs, epsilon, (1, 1))
    zero = _gkp(qs, epsilon, (1, 0))
    one = _gkp(qs, epsilon, (0, 1))

    state = torch.outer(plus, plus)
    f_init = logical_fidelity(qs, state)
    x_src, y_src = shear_maps(qs, 1.0, True)
    state = warp_2d(qs, state[None, :, :, None], x_src, y_src)[0, :, :, 0]
    f_gate = logical_fidelity(qs, state)
    state = gkp_project_sym(qs, state, zero, one, 0)
    state = gkp_project_sym(qs, state, zero, one, 1)
    state = state / torch.sqrt(torch.sum(torch.abs(state) ** 2) * dq ** 2)
    f_proj = logical_fidelity(qs, state)
    return {"initial": f_init, "after_gate": f_gate, "after_projection": f_proj}


def bell_state_comparison(epsilon: float = 0.15, grid_points: int = 500,
                          device=None) -> dict:
    """Qunaught-states-through-a-beamsplitter vs GKP-states-through-CX Bell
    preparation (figures.ipynb cell 12): the qunaught construction yields
    the higher-fidelity logical Bell state."""
    _, qs = _grid(-15, 15, grid_points, resolve_device(device))
    plus = _gkp(qs, epsilon, (1, 1))
    zero = _gkp(qs, epsilon, (1, 0))
    qn = normalise(qs, comb_sym(qs, epsilon, math.sqrt(2 * np.pi)).to(plus.dtype))

    bell_qn = torch.outer(qn, qn)
    before_qn = logical_fidelity(qs, bell_qn)
    x_rot, y_rot = rotation_maps(qs, -np.pi / 4)
    bell_qn = warp_2d(qs, bell_qn[None, :, :, None], x_rot, y_rot)[0, :, :, 0]
    after_qn = logical_fidelity(qs, bell_qn)

    bell_gkp = torch.outer(plus, zero)
    before_gkp = logical_fidelity(qs, bell_gkp)
    x_shear, y_shear = shear_maps(qs, 1.0, True)
    bell_gkp = warp_2d(qs, bell_gkp[None, :, :, None], x_shear, y_shear)[0, :, :, 0]
    after_gkp = logical_fidelity(qs, bell_gkp)
    return {
        "qunaught_before": before_qn, "qunaught_bell": after_qn,
        "gkp_before": before_gkp, "gkp_bell": after_gkp,
    }


if __name__ == "__main__":
    # python -m quantum_computations_tpu_torch.pipelines.gkp_ec_validation [device]
    import sys

    dev = sys.argv[1] if len(sys.argv) > 1 else None
    failed = gaussian_product_identity_check()
    print(f"Gaussian-product identity: {failed} failed cases")
    res = steane_ec_width_test(device=dev)
    print("Steane EC width test:")
    for k, v in res.items():
        print(f"  {k}: {v:.5f}")
    print("Knill-Steane equivalence:", knill_steane_equivalence_check(device=dev))
    print("Imperfect P gate:", imperfect_p_gate_experiment(device=dev))
    print("Imperfect CX gate:", imperfect_cx_gate_experiment(device=dev))
    print("Bell comparison:", bell_state_comparison(device=dev))
