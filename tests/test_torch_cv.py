"""The port's CV engine (``cv/states``, ``cv/mps``, ``cv/gate_abc``,
``cv/gates``, ``cv/simulator``, with ``config`` and ``utils``) against the
JAX package, on the CPU.

The same inputs (numpy, from a seed) go through the JAX package at x64 and
the port in complex128 on the CPU; MPS states cross with
``MPS.from_numpy``/``to_numpy``. Tolerances:
- 1e-10 (relative to the largest magnitude) for states, single-mode gates
  and measurements with a forced outcome: the same float64 formulas;
- 1e-9 for two-mode gates, compared through gauge-invariant quantities
  (the contracted state, norms, partial densities), since an SVD fixes
  each singular vector only up to a phase; kept ranks and bond shapes
  exactly;
- 1e-8 for whole ``Simulator`` runs (S, Q and a three-mode tour at small
  grids), with the JAX run's sampled outcomes forced in the port, on the
  full SVD path and on the randomized path (JAX's own sketches replayed
  in the port): up to ~20 splits and renormalisations compound the 1e-9.
"""

import json
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quantum_computations_tpu import config as jconfig
from quantum_computations_tpu.cv import MPS as JMPS, Simulator as JSim, State as JState
from quantum_computations_tpu.cv import gates as jg
from quantum_computations_tpu.cv import simulator as jsim_mod
from quantum_computations_tpu.cv import states as jstates
from quantum_computations_tpu.ops import linalg as jlinalg
from quantum_computations_tpu_torch import config as tconfig
from quantum_computations_tpu_torch.cv import MPS as TMPS, Simulator as TSim, State as TState
from quantum_computations_tpu_torch.cv import gates as tg
from quantum_computations_tpu_torch.cv import simulator as tsim_mod
from quantum_computations_tpu_torch.cv import states as tstates
from quantum_computations_tpu_torch.ops import linalg as tlinalg
from quantum_computations_tpu_torch.utils import as_generator, profiling

EPS = float(2 * np.arctanh(10 ** (-10 / 10) / 2))  # 10 dB
QS = np.linspace(-12, 12, 96)
STATE_TOL = 1e-10
GATE_TOL = 1e-9
RUN_TOL = 1e-8


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _random_chain(seed, d=len(QS), bonds=(3, 2)):
    rng = np.random.default_rng(seed)
    dims = (1, *bonds, 1)
    ts = [rng.normal(size=(dims[i], d, dims[i + 1]))
          + 1j * rng.normal(size=(dims[i], d, dims[i + 1])) for i in range(len(dims) - 1)]
    scale = (np.sum(np.abs(np.einsum("aib,bjc,ckd->ijk", *ts)) ** 2)
             * ((QS[-1] - QS[0]) / (d - 1)) ** len(ts)) ** (-0.5 / len(ts))
    return [t * scale for t in ts]


def _pair(tensors, qs=QS):
    """The same chain in both packages."""
    return (JMPS(qs, [jnp.asarray(t) for t in tensors]),
            TMPS.from_numpy(qs, tensors, device="cpu"))


def _same_state(tm, jm, tol):
    """Gauge-invariant comparison: bond shapes, the contracted state, the
    norm and every partial density."""
    assert tm.shape() == jm.shape()
    _close(tm.contract().numpy(), jm.contract(), tol)
    _close(float(tm.norm()), float(jm.norm()), tol)
    for k in range(len(tm)):
        _close(tm.partial_density_mps(k).numpy(), jm.partial_density_mps(k), tol)


# ---------------------------------------------------------------------------
# config, utils
# ---------------------------------------------------------------------------

def test_dtypes_follow_device_and_qct_x64(monkeypatch):
    monkeypatch.delenv("QCT_X64", raising=False)
    assert tconfig.complex_dtype("cpu") == torch.complex128
    assert tconfig.real_dtype("cpu") == torch.float64
    assert tconfig.complex_dtype("cuda") == torch.complex64
    assert tconfig.real_dtype(None) == torch.float32
    monkeypatch.setenv("QCT_X64", "1")
    assert tconfig.complex_dtype("cuda") == torch.complex128
    monkeypatch.setenv("QCT_X64", "0")
    assert tconfig.complex_dtype("cpu") == torch.complex64


def test_svd_options_cascade_matches_jax():
    for base, over in (({}, None), ({"max_bond_dim": 100, "rel_err": 1e-2}, {"max_bond_dim": 40}),
                       ({"rel_err": 1e-2}, {"abs_err": 0.1, "svd_method": "full"})):
        t = tconfig.SVDOptions(**base).merged_into(
            None if over is None else tconfig.SVDOptions(**over))
        j = jconfig.SVDOptions(**base).merged_into(
            None if over is None else jconfig.SVDOptions(**over))
        assert [getattr(t, f) for f in ("max_bond_dim", "abs_err", "rel_err", "svd_method")] == \
               [getattr(j, f) for f in ("max_bond_dim", "abs_err", "rel_err", "svd_method")]


def test_as_generator_and_wallclock():
    g = as_generator(5)
    assert as_generator(g) is g
    assert torch.rand(3, generator=as_generator(5)).tolist() == \
        torch.rand(3, generator=torch.Generator().manual_seed(5)).tolist()
    assert isinstance(as_generator(None), torch.Generator)
    with profiling.recording():
        with profiling.span("a"):
            pass
    assert profiling.table()["a"]["calls"] == 1
    with profiling.span("a"):   # outside a recording: not kept
        pass
    assert profiling.table()["a"]["calls"] == 1


def test_format_time_matches_jax():
    for t in (0.0, 0.0123, 59.9996, 61.5, 3725.25):
        assert tsim_mod.format_time(t) == jsim_mod.format_time(t)


# ---------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [s.name for s in JState])
def test_state_eval_matches_jax(name):
    eps = EPS if name != "VACUUM" else None
    want = np.asarray(JState[name].eval(QS, eps))
    got = TState[name].eval(QS, eps, device="cpu")
    assert got.dtype == torch.complex128
    _close(got.numpy(), want, STATE_TOL)
    low = TState[name].eval(QS, eps, device="cpu", dtype=torch.complex64)
    assert low.dtype == torch.complex64


def test_analytic_wavefunctions_match_jax():
    q = np.linspace(-6, 6, 41)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    cases = [
        ("rotated_eigenstate", (0.4, 0.7)), ("momentum_eigenstate", (1.3,)),
        ("squeezed_coherent", (0.5 - 0.8j, 0.3, 0.6)), ("vacuum", ()),
        ("coherent", (1.0 + 0.5j,)), ("squeezed_vac", (-0.4,)),
        ("gkp", (0.3, 0.4, (1, 0.5j))), ("gkp_sym", (0.2, (0.6, 0.8))),
        ("comb", (0.3, 0.4, 2.5)), ("comb_sym", (0.2, 2.5)), ("qunaught", (0.15,)),
    ] + [("fock_state", (n,)) for n in range(6)]
    for fn, args in cases:
        _close(getattr(tstates, fn)(tq, *args).numpy(),
               getattr(jstates, fn)(jq, *args), STATE_TOL)
    _close(tstates.eval_gkp_state(QS, EPS, (1, 1j), device="cpu").numpy(),
           jstates.eval_gkp_state(QS, EPS, (1, 1j)), STATE_TOL)


def test_state_eval_validation_matches_jax():
    for args, exc in (((QS.reshape(2, -1), EPS), TypeError),
                      ((QS ** 3, EPS), ValueError),
                      ((QS, -1.0), ValueError), ((QS, None), ValueError)):
        with pytest.raises(exc):
            JState.GKP_ZERO.eval(*args)
        with pytest.raises(exc):
            TState.GKP_ZERO.eval(*args, device="cpu")
    with pytest.raises(ValueError):
        TState.QUNAUGHT.eval(QS, device="cpu")


# ---------------------------------------------------------------------------
# MPS
# ---------------------------------------------------------------------------

def test_mps_numpy_round_trip_and_validation():
    ts = _random_chain(0)
    m = TMPS.from_numpy(QS, ts, device="cpu")
    assert m.dtype == torch.complex128 and m.device.type == "cpu"
    for a, b in zip(m.to_numpy(), ts):
        np.testing.assert_array_equal(a, b)
    low = TMPS.from_numpy(QS, ts, device="cpu", dtype=torch.complex64)
    assert all(t.dtype == np.complex64 for t in low.to_numpy())
    assert [t.shape for t in m.copy().to_numpy()] == [t.shape for t in ts]
    one = TMPS(QS, [torch.ones(len(QS), dtype=torch.complex128)])
    assert one.shape() == ((1, len(QS), 1),)
    for bad in ([ts[0], ts[2]], [ts[1]], [ts[0][:, :10]]):
        with pytest.raises(ValueError):
            TMPS.from_numpy(QS, bad, device="cpu")
    with pytest.raises(ValueError):
        TMPS(QS ** 3, [], device="cpu")


def test_mps_default_device_is_cuda():
    if torch.cuda.is_available():
        assert TMPS(QS, []).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TMPS(QS, [])


def test_mps_contractions_match_jax():
    jm, tm = _pair(_random_chain(1))
    _same_state(tm, jm, STATE_TOL)
    for D, Dj in zip(tm.density_mps(), jm.density_mps()):
        _close(D.numpy(), Dj, STATE_TOL)
    jb, tb = _pair(_random_chain(2, bonds=(2, 4)))
    _close(float(TMPS.fidelity(tm, tb)), float(JMPS.fidelity(jm, jb)), STATE_TOL)
    with pytest.raises(IndexError):
        tm.partial_density_mps(3)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

SINGLE = [
    ("F", (1,), {}), ("F", (1,), {"dagger": True}), ("X", (1, 0.7), {}),
    ("X", (1, 0.7), {"dagger": True}), ("Z", (2, 1.3), {}), ("D", (0, [1.5, 0.7]), {}),
    ("D", (1, [0.4, -0.2]), {"dagger": True}), ("P", (1, 0.4), {}), ("S", (1, 0.5), {}),
    ("S", (1, -0.5), {}), ("S", (1, 0.4, 0.3), {}), ("S", (2, 0.3, 0.5), {"dagger": True}),
    ("Phase", (1, 0.7), {}), ("Phase", (1, math.pi), {}), ("Phase", (1, 0.0), {}),
    ("Phase", (0, math.pi / 2), {"dagger": True}),
]


@pytest.mark.parametrize("cls,args,kwargs", SINGLE)
def test_single_mode_gates_match_jax(cls, args, kwargs):
    jm, tm = _pair(_random_chain(3))
    getattr(jg, cls)(*args, **kwargs).apply(jm)
    getattr(tg, cls)(*args, **kwargs).apply(tm)
    for a, b in zip(tm.to_numpy(), jm.tensors):
        _close(a, b, STATE_TOL)


@pytest.mark.parametrize("cls,index,arg", [
    ("Mq", 0, None), ("Mq", 1, None), ("Mq", 2, None), ("Mp", 1, None),
    ("Homodyne", 1, 0.7), ("Homodyne", 2, math.pi), ("Homodyne", 0, 0.0)])
def test_measurements_with_forced_outcome_match_jax(cls, index, arg):
    for chain in (_random_chain(4), _random_chain(4)[:1]):
        chain = [chain[0][:, :, :1]] if len(chain) == 1 else chain
        if index >= len(chain):
            continue
        jm, tm = _pair(chain)
        args = (index,) if arg is None else (index, arg)
        jr = getattr(jg, cls)(*args, result=0.9).apply(jm)
        tr = getattr(tg, cls)(*args, result=0.9).apply(tm)
        assert tr.result == float(jr.result)
        _close(float(tr.probability), float(jr.probability), STATE_TOL)
        assert tm.shape() == jm.shape()
        for a, b in zip(tm.to_numpy(), jm.tensors):
            _close(a, b, STATE_TOL)


def test_measurement_sampling_and_errors():
    jm, tm = _pair(_random_chain(5))
    with pytest.raises(ValueError):
        tg.Mq(0).apply(tm)
    gen = torch.Generator().manual_seed(3)
    r = tg.Mq(1).apply(tm, generator=gen)
    assert r.result in QS and len(tm) == 2 and float(r.probability) > 0
    with pytest.raises(ValueError):
        tg.BS(0, 2)
    with pytest.raises(ValueError):
        tg.CZ(0, 1, svd_options=tconfig.SVDOptions(), max_bond_dim=3)
    with pytest.raises(ValueError):
        tg.D(0, [1.0])


OPTS = {"max_bond_dim": 16, "rel_err": 1e-3}
TWO = [
    ("BS", (0, 1), {}), ("BS", (2, 1), {"angle": 0.3}), ("BS", (1, 2), {"dagger": True}),
    ("CZ", (1, 2), {"s": 0.7}), ("CZ", (0, 1), {"dagger": True}), ("CX", (0, 1), {}),
    ("CX", (2, 1), {"s": 0.5}), ("SWAP", (1, 2), {}),
]


@pytest.mark.parametrize("cls,args,kwargs", TWO)
def test_two_mode_gates_match_jax(cls, args, kwargs):
    jm, tm = _pair(_random_chain(6))
    getattr(jg, cls)(*args, **kwargs).apply(jm, key=jax.random.PRNGKey(0),
                                           svd_options=jconfig.SVDOptions(**OPTS))
    getattr(tg, cls)(*args, **kwargs).apply(tm, generator=torch.Generator(),
                                           svd_options=tconfig.SVDOptions(**OPTS))
    _same_state(tm, jm, GATE_TOL)


@pytest.mark.parametrize("cls,args", [("BS", (0, 1)), ("CX", (1, 0))])
def test_gather_warp_backend_matches_jax(monkeypatch, cls, args):
    monkeypatch.setattr(jg, "_WARP_BACKEND", "gather")
    monkeypatch.setattr(tg, "_WARP_BACKEND", "gather")
    jm, tm = _pair(_random_chain(7))
    getattr(jg, cls)(*args).apply(jm, key=jax.random.PRNGKey(0),
                                  svd_options=jconfig.SVDOptions(**OPTS))
    getattr(tg, cls)(*args).apply(tm, generator=torch.Generator(),
                                  svd_options=tconfig.SVDOptions(**OPTS))
    _same_state(tm, jm, GATE_TOL)


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_insert_matches_jax(index):
    jm, tm = _pair(_random_chain(8))
    jg.Insert(index, JState.GKP_PLUS, gkp_epsilon=EPS).apply(
        jm, key=jax.random.PRNGKey(0), svd_options=jconfig.SVDOptions(**OPTS))
    tg.Insert(index, TState.GKP_PLUS, gkp_epsilon=EPS).apply(
        tm, generator=torch.Generator(), svd_options=tconfig.SVDOptions(**OPTS))
    _same_state(tm, jm, GATE_TOL)
    with pytest.raises(IndexError):
        tg.Insert(9, TState.VACUUM).apply(tm)


def _record_jax_sketches(monkeypatch):
    """JAX's own sketches, in the order its randomized splits draw them."""
    sketches = []
    real = jlinalg.randomized_range_finder

    def record(A, l, q, key):
        sketches.append(np.array(jax.random.normal(key, (A.shape[1], l), dtype=A.real.dtype)))
        return real(A, l, q, key)

    monkeypatch.setattr(jlinalg, "randomized_range_finder", record)
    return sketches


def _replay_sketches(monkeypatch, sketches):
    def replay(n, l, generator, like):
        o = sketches.pop(0)
        assert o.shape == (n, l)
        return torch.from_numpy(o).to(like.dtype)

    monkeypatch.setattr(tlinalg, "_gaussian_sketch", replay)


def test_two_mode_gate_randomized_path_with_shared_sketch(monkeypatch):
    """max_bond_dim * 10 < min(a d, d b): both packages take Halko's path."""
    jm, tm = _pair(_random_chain(9))
    sketches = _record_jax_sketches(monkeypatch)
    opts = {"max_bond_dim": 4, "rel_err": 1e-3}
    jg.BS(1, 2).apply(jm, key=jax.random.PRNGKey(1), svd_options=jconfig.SVDOptions(**opts))
    assert len(sketches) == 1
    _replay_sketches(monkeypatch, sketches)
    tg.BS(1, 2).apply(tm, generator=torch.Generator(), svd_options=tconfig.SVDOptions(**opts))
    assert not sketches
    _same_state(tm, jm, GATE_TOL)


# ---------------------------------------------------------------------------
# whole circuits through the Simulator
# ---------------------------------------------------------------------------

def _circuit(name, g, State, forced=()):
    f = iter(forced)
    m = lambda: next(f, None)  # noqa: E731

    def quadrature_correction():
        return [g.Insert(1, State.GKP_ZERO, gkp_epsilon=EPS), g.CZ(0, 1), g.Mp(1, result=m())]

    if name == "S":  # Steane EC
        first = quadrature_correction()
        return [*first, g.F(0, dagger=True), *quadrature_correction(), g.F(0)]
    if name == "Q":  # qunaught EC
        return [g.Insert(1, State.QUNAUGHT, gkp_epsilon=EPS),
                g.Insert(2, State.QUNAUGHT, gkp_epsilon=EPS),
                g.BS(2, 1), g.BS(1, 0), g.Mq(0, result=m()), g.Mp(0, result=m())]
    # T: every gate class on three modes, from an empty chain
    return [g.Insert(0, State.GKP_ZERO, gkp_epsilon=EPS),
            g.Insert(1, State.GKP_PLUS, gkp_epsilon=EPS),
            g.Insert(2, State.GKP_T, gkp_epsilon=EPS),
            g.BS(0, 1), g.CZ(1, 2), g.CX(2, 1), g.SWAP(0, 1), g.F(0), g.X(1, 0.3),
            g.Z(2, 0.4), g.D(0, [0.2, -0.3]), g.P(1, 0.5), g.S(2, 0.2, np.pi / 2),
            g.Phase(0, np.pi / 3), g.BS(1, 2, 0.3, dagger=True), g.CX(0, 1, s=0.5),
            g.Mq(2, result=m()), g.Insert(1, State.VACUUM), g.CZ(1, 2),
            g.Homodyne(1, np.pi / 3, result=m()), g.Mp(1, result=m())]


def _initial(name, qs):
    if name == "T":
        return JMPS(qs, []), TMPS(qs, [], device="cpu")
    return (JMPS(qs, [JState.GKP_H.eval(qs, EPS)]),
            TMPS(qs, [TState.GKP_H.eval(qs, EPS, device="cpu")]))


@pytest.mark.parametrize("name,max_bond_dim,d", [
    ("S", 16, 96), ("Q", 16, 96), ("T", 12, 64), ("Q", 2, 96)])
def test_simulator_matches_jax(monkeypatch, name, max_bond_dim, d):
    """The JAX run samples its outcomes; the port runs with them forced.
    At max_bond_dim = 2 every two-mode split of Q takes the randomized
    path, on JAX's replayed sketches."""
    qs = np.linspace(-12, 12, d)
    opts = {"max_bond_dim": max_bond_dim, "rel_err": 1e-2}
    sketches = _record_jax_sketches(monkeypatch)
    j0, t0 = _initial(name, qs)
    jsim = JSim(_circuit(name, jg, JState), rng_seed=11, svd_options=opts)
    jout = jsim.run(j0)
    outcomes = [float(r.result) for r in jsim.results]
    assert (len(sketches) > 0) == (max_bond_dim == 2)
    _replay_sketches(monkeypatch, sketches)
    tsim = TSim(_circuit(name, tg, TState, outcomes), rng_seed=11, svd_options=opts)
    tout = tsim.run(t0)
    assert not sketches
    assert [r.result for r in tsim.results] == outcomes
    for a, b in zip(tsim.results, jsim.results):
        _close(float(a.probability), float(b.probability), RUN_TOL)
    _same_state(tout, jout, RUN_TOL)


def test_simulator_seed_gives_the_same_outcomes():
    def outcomes(seed):
        sim = TSim(_circuit("Q", tg, TState), rng_seed=seed,
                   svd_options={"max_bond_dim": 8, "rel_err": 1e-2})
        sim.run(_initial("Q", QS)[1])
        return [r.result for r in sim.results]

    first = outcomes(5)
    assert first == outcomes(5)
    assert first == outcomes(torch.Generator().manual_seed(5))
    assert len(first) == 2


def test_simulator_writes_a_trace_with_one_span_per_gate(tmp_path):
    gates = _circuit("S", tg, TState)
    TSim(gates, rng_seed=0, svd_options={"max_bond_dim": 8}).run(
        _initial("S", QS)[1], profile_dir=str(tmp_path))
    (trace,) = Path(tmp_path).glob("*.json")
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if str(e.get("name", "")).startswith("cv:")]
    assert sorted(set(names)) == ["cv:CZ", "cv:F", "cv:Insert", "cv:Mp"]
    assert len(names) == len(gates)
