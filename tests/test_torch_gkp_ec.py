"""The second paper's pipelines in the port (``pipelines/cv_circuits``,
``pipelines/gkp_ec``, ``pipelines/gkp_ec_validation``) against the JAX
package on the CPU at x64.

The same seeded numpy inputs go through both packages; the port runs in
complex128 on the CPU. Tolerances (relative to the largest magnitude):
- 1e-10 for every ``gkp_ec`` function (the same float64 formulas; FFTs and
  sums in another order);
- 1e-10 for the validation experiments' fidelities, Wigner differences and
  overlaps, 1e-8 relative for the fitted widths (scipy's ``curve_fit`` from
  inputs equal to ~1e-13 stops at its own tolerance);
- 1e-8 for whole ``cv.Simulator`` runs of the ``cv_circuits`` lists with
  the JAX run's outcomes forced and its randomized-SVD sketches replayed
  (as ``tests/test_torch_cv.py``'s whole-circuit runs).
The grids are small (64 to 400 points), one BLAS thread.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from quantum_computations_tpu.cv import MPS as JMPS, Simulator as JSim, State as JState
from quantum_computations_tpu.gkp import db2eps, full_logical_density_mps as jdensity
from quantum_computations_tpu.pipelines import cv_circuits as jcc, gkp_ec as jec
from quantum_computations_tpu.pipelines import gkp_ec_validation as jval

from quantum_computations_tpu_torch.cv import MPS as TMPS, Simulator as TSim, State as TState
from quantum_computations_tpu_torch.cv.gates import Mq as TMq
from quantum_computations_tpu_torch.gkp import full_logical_density_mps as tdensity
from quantum_computations_tpu_torch.pipelines import cv_circuits as tcc, gkp_ec as tec
from quantum_computations_tpu_torch.pipelines import gkp_ec_validation as tval

from test_torch_cv import _record_jax_sketches, _replay_sketches

FN_TOL = 1e-10
EXP_TOL = 1e-10
FIT_RTOL = 1e-8
RUN_TOL = 1e-8
QS = np.linspace(-12, 12, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread and one BLAS thread per test process (the
    tier-1 run puts six test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jnp.linalg.svd(jnp.eye(2))
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


def _random(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _gkp(qs, mu):
    """A normalised 10 dB GKP state (host complex128, from the port)."""
    eps = float(db2eps(10.0))
    t = tec.normalise(qs, tec.gkp_sym(torch.as_tensor(qs), eps, mu).to(torch.complex128))
    return t.numpy()


# ---------------------------------------------------------------------------
# gkp_ec, function by function
# ---------------------------------------------------------------------------

def test_normalise_and_fourier_match_jax():
    x = _random(len(QS), 1)
    _close(tec.normalise(QS, torch.from_numpy(x)).numpy(),
           np.asarray(jec.normalise(QS, jnp.asarray(x))), FN_TOL)
    _close(tec.fourier(QS, torch.from_numpy(x)).numpy(),
           np.asarray(jec.fourier(QS, jnp.asarray(x))), FN_TOL)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["asym", "sym"])
def test_projectors_match_jax(kind, axis):
    state = _random((len(QS), len(QS)), 2 + axis)
    zero, one = _gkp(QS, (1, 0)), _gkp(QS, (0, 1))
    if kind == "asym":
        got = tec.gkp_project_asym(QS, torch.from_numpy(state), torch.from_numpy(zero), axis)
        want = jec.gkp_project_asym(QS, jnp.asarray(state), jnp.asarray(zero), axis)
    else:
        got = tec.gkp_project_sym(QS, torch.from_numpy(state), torch.from_numpy(zero),
                                  torch.from_numpy(one), axis)
        want = jec.gkp_project_sym(QS, jnp.asarray(state), jnp.asarray(zero),
                                   jnp.asarray(one), axis)
    _close(got.numpy(), np.asarray(want), FN_TOL)


def test_measurement_operators_match_jax():
    for got, want in zip(tec._measurement_operators(QS), jec._measurement_operators(QS)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_modes", [1, 2])
def test_full_logical_density_and_fidelity_match_jax(n_modes):
    if n_modes == 1:
        state = _gkp(QS, (np.cos(0.3), np.sin(0.3))) + 0.05 * _random(len(QS), 5)
    else:
        state = np.multiply.outer(_gkp(QS, (1, 1)), _gkp(QS, (1, 0))) \
            + 0.05 * _random((len(QS), len(QS)), 6)
    got = tec.full_logical_density(QS, torch.from_numpy(state))
    assert got.shape == (2**n_modes, 2**n_modes) and got.dtype == torch.complex128
    _close(got.numpy(), np.asarray(jec.full_logical_density(QS, jnp.asarray(state))), FN_TOL)
    f_t = tec.logical_fidelity(QS, torch.from_numpy(state))
    f_j = jec.logical_fidelity(QS, jnp.asarray(state))
    assert isinstance(f_t, float)
    assert abs(f_t - f_j) <= FN_TOL * abs(f_j)


def test_tickmarks_match_jax():
    for alt in (False, True):
        t, j = tec.get_tickmarks(-7.0, 9.0, alt), jec.get_tickmarks(-7.0, 9.0, alt)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]


# ---------------------------------------------------------------------------
# gkp_ec_validation: the six experiments at small grids
# ---------------------------------------------------------------------------

EXPERIMENTS = {
    "steane_ec_width_test": dict(grid_points=300),
    "knill_steane_equivalence_check": dict(grid_points=300),
    "imperfect_p_gate_experiment": dict(grid_points=300),
    "imperfect_cx_gate_experiment": dict(grid_points=200),
    "bell_state_comparison": dict(grid_points=200),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_validation_experiment_matches_jax(name):
    kw = EXPERIMENTS[name]
    got = getattr(tval, name)(**kw, device="cpu")
    want = getattr(jval, name)(**kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("numeric_"):
            assert abs(got[k] - v) <= FIT_RTOL * abs(v), (k, got[k], v)
        elif k == "max_wigner_diff":  # relative to the Wigner peak
            peak = v / want["rel_wigner_diff"]
            assert abs(got[k] - v) <= EXP_TOL * peak, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= EXP_TOL * max(abs(v), 1.0), (k, got[k], v)


def test_gaussian_product_identity_matches_jax():
    kw = dict(samples=8, seed=3, grid_points=300)
    assert tval.gaussian_product_identity_check(**kw) == \
        jval.gaussian_product_identity_check(**kw) == 0


def test_validation_default_device_is_cuda(monkeypatch):
    """Without a card the default device raises; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.imperfect_p_gate_experiment(grid_points=64)


# ---------------------------------------------------------------------------
# cv_circuits: the lists, and the JAX tests' circuits through cv.Simulator
# ---------------------------------------------------------------------------

CIRCUITS = ["qunaught_error_correction", "quadrature_correction",
            "steane_error_correction", "bell_standard", "bell_qunaught"]


def _gate_fields(g):
    return {k: (v.name if hasattr(v, "name") else v) for k, v in vars(g).items()
            if not k.startswith("_")}


@pytest.mark.parametrize("name", CIRCUITS)
def test_cv_circuit_lists_match_jax(name):
    eps = float(db2eps(10.0))
    got, want = getattr(tcc, name)(eps), getattr(jcc, name)(eps)
    assert [type(g).__name__ for g in got] == [type(g).__name__ for g in want]
    for t, j in zip(got, want):
        tf, jf = _gate_fields(t), _gate_fields(j)
        assert set(tf) == set(jf), (t, j)
        for k in jf:
            if isinstance(jf[k], (float, int, complex, np.number)) or jf[k] is None:
                assert tf[k] == pytest.approx(jf[k], rel=0, abs=1e-15), (t, k)
            else:
                assert repr(tf[k]) == repr(jf[k]), (t, k)


CV_QS = np.linspace(-20, 20, 400)
CV_EPS = float(db2eps(10.0))
CV_SVD = {"max_bond_dim": 16, "rel_err": 1e-2}
SIM_RUNS = {  # the circuits of tests/test_cv_circuits.py: (initial state, seed)
    "quadrature_correction": ("GKP_ZERO", 2),
    "steane_error_correction": ("GKP_PLUS", 4),
    "bell_qunaught": (None, 5),
}


@pytest.mark.parametrize("name", sorted(SIM_RUNS))
def test_cv_circuit_runs_match_jax(monkeypatch, name):
    init, seed = SIM_RUNS[name]
    sketches = _record_jax_sketches(monkeypatch)
    j0 = JMPS(CV_QS, [getattr(JState, init).eval(CV_QS, CV_EPS)] if init else [])
    jsim = JSim(getattr(jcc, name)(CV_EPS), rng_seed=seed, svd_options=CV_SVD)
    jout = jsim.run(j0)
    outcomes = [float(r.result) for r in jsim.results]
    _replay_sketches(monkeypatch, sketches)
    circ = getattr(tcc, name)(CV_EPS)
    forced = iter(outcomes)
    for g in circ:
        if isinstance(g, TMq):
            g.result = next(forced)
    t0 = TMPS(CV_QS, [getattr(TState, init).eval(CV_QS, CV_EPS, device="cpu")]
              if init else [], device="cpu")
    tsim = TSim(circ, rng_seed=seed, svd_options=CV_SVD)
    tout = tsim.run(t0)
    assert not sketches
    assert [r.result for r in tsim.results] == outcomes
    assert len(tout) == len(jout)
    for a, b in zip(tsim.results, jsim.results):
        _close(float(a.probability), float(b.probability), RUN_TOL)
    _close(tdensity(tout, normalised=True).numpy(),
           np.asarray(jdensity(jout, normalised=True)), RUN_TOL)
