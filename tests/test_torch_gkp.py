"""The port's measurement-based GKP engine (``gkp/utils``, ``gkp/bell``,
``gkp/gates``, ``gkp/transpiler``, ``gkp/simulator``) against the JAX
package, on the CPU.

The same inputs go through both packages at x64 (MPS states cross as
numpy). Sampling uses two different generators, so the whole-circuit
runs record the JAX run's homodyne outcomes (at ``cv.gates.Mq.apply``,
which every homodyne reaches), its streamed-split sketches and its
randomized-SVD sketches, and replay all three in the port. Tolerances
(relative to the largest magnitude):
- 1e-10 for the readout operators, the logical density of a given MPS,
  Bell states and their splice (the same float64 formulas), and against
  an independent 4^N-loop readout;
- 1e-8 for one gadget run with forced outcomes (up to four splits and
  four renormalising homodynes) and for whole ``gkp.Simulator`` /
  ``SimulatorAlt`` runs (the final MPS, the logical density), with both
  packages' stream thresholds at 16 d^2 so that the interior splits of a
  two-qubit gadget stream. States are compared through gauge-invariant
  quantities (the contracted state, partial densities), since an SVD
  fixes each singular vector only up to a phase. Syndromes, transpiled
  layers and frames exactly.
"""

from itertools import product as iprod

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import quantum_computations_tpu.cv.gates as jcg
import quantum_computations_tpu.ops.linalg as jlinalg
import quantum_computations_tpu.ops.streamed as jst
from quantum_computations_tpu import gkp as J
from quantum_computations_tpu.config import SVDOptions as JOpts
from quantum_computations_tpu.cv import MPS as JMPS, State as JCV
from quantum_computations_tpu.cv.simulator import Simulator as JCVSim
from quantum_computations_tpu.dv import gates as jdv, State as JDV
from quantum_computations_tpu_torch import gkp as T
from quantum_computations_tpu_torch.config import SVDOptions as TOpts
from quantum_computations_tpu_torch.cv import MPS as TMPS, State as TCV
from quantum_computations_tpu_torch.cv import gates as tcg
from quantum_computations_tpu_torch.cv.simulator import Simulator as TCVSim
from quantum_computations_tpu_torch.dv import Simulator as TDVSim, qop as tqop
from quantum_computations_tpu_torch.dv import gates as tdv, State as TDV
from quantum_computations_tpu_torch.ops import linalg as tlinalg
from quantum_computations_tpu_torch.ops import streamed as tst

EXACT_TOL = 1e-10
RUN_TOL = 1e-8
EPS = float(J.db2eps(10.0))
QS = np.linspace(-20, 20, 256)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


def _same_state(tm, jm, tol):
    assert tm.shape() == jm.shape()
    _close(tm.contract().numpy(), jm.contract(), tol)
    for k in range(len(tm)):
        _close(tm.partial_density_mps(k).numpy(), jm.partial_density_mps(k), tol)


def _dv(gate):
    """The port's DV gate of the same class and qubits."""
    return getattr(tdv, type(gate).__name__)(*gate.indices)


# ---------------------------------------------------------------------------
# utils and the readout
# ---------------------------------------------------------------------------

def test_units_results_and_syndrome_matrix_match_jax():
    for db in (5.0, 9.17, 10.0, 15.0):
        assert T.db2eps(db) == J.db2eps(db)
        assert np.isclose(T.eps2db(T.db2eps(db)), db, atol=1e-10)
    for s in (0.0, 1.3, -2.9, 7.7, np.sqrt(np.pi) * 2.5):
        n, r = T.decomp_result(s)
        jn, jr = J.decomp_result(s)
        assert n == jn and r == jr
        assert T.format_result(s) == J.format_result(s)
        assert T.cv2dv_information(s) == J.cv2dv_information(s)
    for syn in ([(0, 0)], [(1, 0)], [(1, 1), (0, 1)], [(0, 1), (1, 0), (1, 1)]):
        got = T.syndrome_matrix(syn)
        assert got.dtype == torch.float64
        _close(got.numpy(), J.syndrome_matrix(syn), EXACT_TOL)


def test_pauli_measurement_operators_match_jax():
    got = T.utils.pauli_measurement_operators(QS)
    assert got.dtype == np.complex128 and got.shape == (4, 256, 256)
    _close(got, J.utils.pauli_measurement_operators(QS), EXACT_TOL)


def _reference_logical_density(tensors, qs):
    """An independent 4^N-loop readout (the Shaw et al. operator sums) in
    plain numpy."""
    dq = (qs[-1] - qs[0]) / len(qs)
    qd = qs[:, None] - qs[None, :]
    sq = np.sqrt(np.pi)
    Xm = np.zeros((len(qs), len(qs)))
    Zm = np.zeros((len(qs), len(qs)))
    for n, m in enumerate(range(1, int((qs[-1] - qs[0]) / sq) + 1, 2)):
        coeff = (-1) ** (n % 2) * 2 / (m * np.pi)
        Xm += coeff * (np.sinc((qd - m * sq) / dq) + np.sinc((qd + m * sq) / dq))
        Zm += coeff * np.diag(2 * np.cos(sq * m * qs))
    Pms = [np.identity(len(qs)), Xm, 1j * Xm @ Zm, Zm]
    Ps = [np.eye(2), np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]),
          np.array([[1, 0], [0, -1]])]
    N = len(tensors)
    rho = np.zeros((2**N, 2**N), dtype=complex)
    for index in iprod(*[[0, 1, 2, 3]] * N):
        coeff = np.ones((1, 1))
        for i, m in zip(index, tensors):
            coeff = np.einsum("ab,aci,bdj,dc->ij", coeff, m, np.conj(m), Pms[i], optimize=True)
        pauli = 1
        for i in index:
            pauli = np.kron(pauli, Ps[i])
        rho = rho + coeff[0, 0] * (dq / 2) ** N * pauli
    return rho


def test_readout_of_a_bell_pair_matches_jax_and_the_4n_loop():
    bell = T.GKPBellState.PLUS.eval(QS, EPS, device="cpu")
    jbell = J.GKPBellState.PLUS.eval(QS, EPS)
    for a, b in zip(bell.to_numpy(), jbell.tensors, strict=True):
        _close(a, b, EXACT_TOL)
    got = T.full_logical_density_mps(bell).numpy()
    _close(got, J.full_logical_density_mps(jbell), EXACT_TOL)
    _close(got, _reference_logical_density(bell.to_numpy(), QS), EXACT_TOL)
    rho = T.full_logical_density_mps(bell, normalised=True)
    ket = np.zeros(4)
    ket[0] = ket[3] = 2**-0.5
    assert float(tqop.fidelity(ket, rho)) > 0.95


def test_readout_of_encoded_states_and_the_dense_variant():
    for cv_state, ket in ((TCV.GKP_ZERO, [1.0, 0.0]),
                          (TCV.GKP_PLUS, np.array([1.0, 1.0]) / np.sqrt(2)),
                          (TCV.GKP_T, np.array([1.0, np.exp(1j * np.pi / 4)]) / np.sqrt(2))):
        mps = TMPS(QS, [cv_state.eval(QS, EPS, device="cpu")])
        rho = T.full_logical_density_mps(mps, normalised=True)
        assert float(tqop.fidelity(np.asarray(ket), rho)) > 0.98, cv_state
    qs = np.linspace(-12, 12, 48)
    zero, plus = (s.eval(qs, EPS, device="cpu") for s in (TCV.GKP_ZERO, TCV.GKP_PLUS))
    dense = torch.einsum("i,j->ij", zero, plus)
    _close(T.full_logical_density(qs, dense).numpy(),
           J.full_logical_density(qs, jnp.asarray(dense.numpy())), EXACT_TOL)


# ---------------------------------------------------------------------------
# Bell insertion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("bell", ["PLUS", "T", "Tdg"])
def test_insert_bell_matches_jax(index, bell):
    """At the start, in the middle (the SVD-free splice) and at the end."""
    zero, one = (s.eval(QS, EPS) for s in (JCV.GKP_ZERO, JCV.GKP_PLUS))
    rng = np.random.default_rng(index)
    mix = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    # a two-mode chain with bond 2
    ts = [np.stack([np.asarray(zero), np.asarray(one)], -1)[None] * mix[0][None, None],
          np.stack([np.asarray(one), np.asarray(zero)], 0)[..., None] * mix[1][:, None, None]]
    jm = JMPS(QS, [jnp.asarray(t) for t in ts])
    tm = TMPS.from_numpy(QS, ts, device="cpu")
    J.InsertBell(index, J.GKPBellState[bell], gkp_epsilon=EPS).apply(
        jm, key=jax.random.PRNGKey(0), svd_options=JOpts(max_bond_dim=24))
    T.InsertBell(index, T.GKPBellState[bell], gkp_epsilon=EPS).apply(
        tm, generator=torch.Generator(), svd_options=TOpts(max_bond_dim=24))
    assert len(tm) == 4
    tm.validate()
    for a, b in zip(tm.to_numpy(), jm.tensors, strict=True):
        _close(a, b, EXACT_TOL)
    with pytest.raises(IndexError):
        T.InsertBell(7, gkp_epsilon=EPS).apply(tm)
    with pytest.raises(TypeError):
        T.InsertBell(0, TCV.GKP_ZERO)


def test_splice_is_exact():
    rng = np.random.default_rng(5)
    t1 = torch.from_numpy(rng.normal(size=(2, 8, 3)) + 0j)
    b1 = torch.from_numpy(rng.normal(size=(8, 2)) + 1j * rng.normal(size=(8, 2)))
    b2 = torch.from_numpy(rng.normal(size=(2, 8)) + 1j * rng.normal(size=(2, 8)))
    b1_t, b2_t = T.bell.splice_product_segment(t1, b1, b2)
    assert b1_t.shape == (3, 8, 6) and b2_t.shape == (6, 8, 3)
    want1 = torch.zeros(3, 8, 3, 2, dtype=b1.dtype)
    want2 = torch.zeros(3, 2, 8, 3, dtype=b2.dtype)
    for r in range(3):
        want1[r, :, r, :] = b1
        want2[r, :, :, r] = b2
    assert torch.equal(b1_t, want1.reshape(3, 8, 6))
    assert torch.equal(b2_t, want2.reshape(6, 8, 3))


# ---------------------------------------------------------------------------
# gadgets, syndromes, transpiler, frame
# ---------------------------------------------------------------------------

GADGETS = [("MBI", (0,)), ("MBF", (0,)), ("MBP", (0,)), ("MBT", (0,)),
           ("MBCZ", (0, 1)), ("MBSWAP", (1, 0))]


def _compiled(gadget):
    out = []
    for g in gadget.compile():
        row = [type(g).__name__]
        if hasattr(g, "index1"):
            row += [g.index1, g.index2, float(g.arg)]
        else:
            row += [g.index, str(g.arg) if type(g).__name__ == "InsertBell"
                    else float(g.arg if g.arg is not None else 0.0)]
        if type(g).__name__ == "Homodyne":
            row.append(g.result)
        out.append(row)
    return out


@pytest.mark.parametrize("name,indices", GADGETS)
@pytest.mark.parametrize("dagger", [False, True])
def test_gadget_compile_and_syndrome_match_jax(name, indices, dagger):
    rng = np.random.default_rng(len(name) + dagger)
    n = 2 if len(indices) == 1 else 4
    results = [float(x) for x in rng.normal(scale=3.0, size=n)]
    tg_ = getattr(T, name)(*indices, epsilon=EPS, dagger=dagger, results=results)
    jg_ = getattr(J, name)(*indices, epsilon=EPS, dagger=dagger, results=results)
    assert _compiled(tg_) == _compiled(jg_)
    assert repr(tg_) == repr(jg_)
    np.testing.assert_array_equal(tg_.angles(), jg_.angles())
    for _ in range(20):
        res = [float(x) for x in rng.normal(scale=4.0, size=n)]
        syn, idx = tg_.compute_syndrome(res)
        jsyn, jidx = jg_.compute_syndrome(res)
        assert idx == jidx
        assert syn == [(int(x), int(z)) for x, z in jsyn]
        assert all(isinstance(b, int) for s in syn for b in s)
    with pytest.raises(ValueError):
        tg_.compute_syndrome(res[:-1])
    with pytest.raises(ValueError):
        getattr(T, name)(*indices, results=[0.0] * (n + 1))


def test_two_mode_gadgets_need_neighbours():
    with pytest.raises(ValueError):
        T.MBCZ(0, 2)
    g = T.MBI(0, epsilon=EPS, max_bond_dim=12)
    assert g.svd_options == TOpts(max_bond_dim=12)
    assert T.GKPEC is T.MBI


@pytest.mark.parametrize("name,indices", [("MBI", (0,)), ("MBT", (1,)), ("MBCZ", (0, 1))])
def test_gadget_run_with_forced_results_matches_jax(monkeypatch, name, indices):
    """One gadget on a two-qubit GKP chain through the nested CV engine:
    the JAX gadget samples its outcomes, the port's takes them as
    ``results=`` and replays JAX's randomized-SVD sketches."""
    qs = np.linspace(-12, 12, 64)
    opts = {"max_bond_dim": 24, "rel_err": 1e-2}
    streamed, rsvd, _ = _record_jax(monkeypatch)
    jsim = JCVSim(getattr(J, name)(*indices, epsilon=EPS).compile(),
                  rng_seed=0, svd_options=opts)
    jout = jsim.run(J.parse_to_mps([JDV.ZERO, JDV.PLUS], EPS, qs))
    outcomes = [float(r.result) for r in jsim.results]
    _replay_in_port(monkeypatch, streamed, rsvd)
    tsim = TCVSim(getattr(T, name)(*indices, epsilon=EPS, results=outcomes).compile(),
                  rng_seed=0, svd_options=opts)
    tout = tsim.run(T.parse_to_mps([TDV.ZERO, TDV.PLUS], EPS, qs, device="cpu"))
    assert not streamed and not rsvd
    assert [r.result for r in tsim.results] == outcomes
    for a, b in zip(tsim.results, jsim.results):
        _close(float(a.probability), float(b.probability), RUN_TOL)
    _same_state(tout, jout, RUN_TOL)


CIRCUITS = {
    "1q": ([jdv.H(0), jdv.P(0)], 1),
    "G2": ([jdv.H(0), jdv.CZ(0, 1), jdv.P(0), jdv.T(1), jdv.H(1), jdv.SWAP(0, 1)], 2),
    "paulis": ([jdv.X(0), jdv.H(1), jdv.Z(1), jdv.Y(0), jdv.X(0), jdv.CZ(0, 1),
                jdv.Tdg(2), jdv.X(2), jdv.SWAP(1, 2), jdv.Pdg(0), jdv.I(1), jdv.Z(2),
                jdv.T(0), jdv.Z(0), jdv.Z(0)], 3),
}


def _layers(circ):
    out = []
    for layer in circ._layers:
        gates = []
        for g in layer.gates:
            inner = g.gate if hasattr(g, "gate") else g
            gates.append((type(g).__name__, type(inner).__name__, list(inner.indices),
                          getattr(g, "_pos", None), getattr(g, "_neg", None)))
        out.append((gates, [list(p) for p in layer.paulis]))
    return out


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("fill", [False, True])
def test_transpiler_matches_jax(name, fill):
    gates, _ = CIRCUITS[name]
    jc = J.MBGKPCircuit.transpile(gates)
    tc = T.MBGKPCircuit.transpile([_dv(g) for g in gates])
    if fill:
        jc.fill()
        tc.fill()
    assert _layers(tc) == _layers(jc)
    assert (tc.depth(), tc.count(), tc.to_string()) == (jc.depth(), jc.count(), jc.to_string())
    assert tc._next_free == jc._next_free


def test_transpiler_gadgets_states_and_errors():
    for gate in (jdv.I(0), jdv.H(0), jdv.P(1), jdv.Pdg(1), jdv.T(0), jdv.Tdg(0),
                 jdv.CZ(0, 1), jdv.SWAP(1, 0)):
        for dagger in (False, True):
            tg_ = T.gate_transpile(_dv(gate), epsilon=EPS, dagger=dagger)
            jg_ = J.gate_transpile(gate, epsilon=EPS, dagger=dagger)
            assert (type(tg_).__name__, tg_.indices, tg_.dagger, tg_.epsilon) == \
                (type(jg_).__name__, jg_.indices, jg_.dagger, jg_.epsilon)
    with pytest.raises(ValueError):
        T.gate_transpile(tdv.X(0))
    for bad in ([tdv.CZ(0, 2)], [tdv.CX(0, 1)]):
        with pytest.raises(ValueError):
            T.MBGKPCircuit.transpile(bad)
    with pytest.raises(ValueError):
        T.MBGKPCircuit(2).add_gate(tdv.H(3))
    for s in TDV:
        assert T.state_transpile(s).name == J.state_transpile(JDV[s.name]).name
    m = T.parse_to_mps([TDV.ZERO, TDV.T], EPS, QS, device="cpu")
    jm_ = J.parse_to_mps([JDV.ZERO, JDV.T], EPS, QS)
    for a, b in zip(m.to_numpy(), jm_.tensors, strict=True):
        _close(a, b, EXACT_TOL)
    assert T.parse_to_mps(m, EPS, QS) is m
    assert len(T.parse_to_mps(None, EPS, QS, device="cpu")) == 0
    with pytest.raises(TypeError):
        T.parse_to_mps("zero", EPS, QS, device="cpu")


def test_commute_matches_jax():
    pairs = [(0, 0), (1, 0), (0, 1), (1, 1)]
    for gate in (jdv.I(0), jdv.H(1), jdv.P(0), jdv.Pdg(1), jdv.T(0), jdv.Tdg(1),
                 jdv.CZ(0, 1), jdv.SWAP(1, 0)):
        for frame in iprod(pairs, pairs):
            got_frame, got_gate = T.commute(_dv(gate), list(frame))
            want_frame, want_gate = J.commute(gate, list(frame))
            assert got_frame == want_frame
            assert (type(got_gate).__name__, got_gate.indices) == \
                (type(want_gate).__name__, want_gate.indices)
    with pytest.raises(NotImplementedError):
        T.commute(tdv.CX(0, 1), [(0, 0), (0, 0)])


# ---------------------------------------------------------------------------
# whole circuits through the engines
# ---------------------------------------------------------------------------

RUN_D = 64
RUN_QS = np.linspace(-12, 12, RUN_D)
RUN_OPTS = {"max_bond_dim": 8, "rel_err": 1e-2}


def _record_jax(mp):
    """Record, in order, the JAX package's streamed-split sketches, its
    randomized-SVD sketches and its homodyne outcomes."""
    streamed, rsvd, outcomes = [], [], []
    real_driver, real_rrf, real_mq = (jst._streamed_driver,
                                      jlinalg.randomized_range_finder, jcg.Mq.apply)

    def driver(t1, t2, qs, warp_params, **kw):
        a, d, _ = t1.shape
        b = t2.shape[-1]
        cap = min(kw["max_bond_dim"], a * d, d * b)
        l = min(cap + jlinalg.OVERSAMPLE, a * d, d * b)
        streamed.append(np.array(jax.random.normal(kw["key"], (d, b, l),
                                                   dtype=jnp.float64)))
        return real_driver(t1, t2, qs, warp_params, **kw)

    def rrf(A, l, q, key):
        rsvd.append(np.array(jax.random.normal(key, (A.shape[1], l), dtype=A.real.dtype)))
        return real_rrf(A, l, q, key)

    def mq(self, mps, **kw):
        out = real_mq(self, mps, **kw)
        outcomes.append(float(out.result))
        return out

    mp.setattr(jst, "_streamed_driver", driver)
    mp.setattr(jlinalg, "randomized_range_finder", rrf)
    mp.setattr(jcg.Mq, "apply", mq)
    return streamed, rsvd, outcomes


def _replay_in_port(mp, streamed, rsvd, outcomes=None):
    """Feed the recorded sketches (and, if given, outcomes) to the port in
    the order it asks for them."""
    def replay_stream(d, b, l, generator, like):
        o = streamed.pop(0)
        assert o.shape == (d, b, l)
        return torch.from_numpy(o).to(like.dtype)

    def replay_rsvd(n, l, generator, like):
        o = rsvd.pop(0)
        assert o.shape == (n, l)
        return torch.from_numpy(o).to(like.dtype)

    mp.setattr(tst, "_stream_sketch", replay_stream)
    mp.setattr(tlinalg, "_gaussian_sketch", replay_rsvd)
    if outcomes is not None:
        real_tmq = tcg.Mq.apply

        def forced_mq(self, mps, **kw):
            self.result = outcomes.pop(0)
            return real_tmq(self, mps, **kw)

        mp.setattr(tcg.Mq, "apply", forced_mq)


def _parity_run(name, engine, decomp):
    """One JAX run (seed 3) with its outcomes and sketches recorded, and
    the port's run with them replayed; both packages split a streamed BS
    by ``decomp`` (``_BS_DECOMP``)."""
    gates, n = CIRCUITS[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcg, "_STREAM_THRESHOLD", 16 * RUN_D**2)
        mp.setattr(tcg, "_STREAM_THRESHOLD", 16 * RUN_D**2)
        mp.setattr(jst, "_BS_DECOMP", decomp)
        mp.setattr(tst, "_BS_DECOMP", decomp)
        streamed, rsvd, outcomes = _record_jax(mp)
        jc = J.MBGKPCircuit.transpile(gates)
        jc.fill()
        jsim = getattr(J, engine)(jc, ancilla_epsilon=EPS, rng_seed=3, svd_options=RUN_OPTS)
        jout, jsyn = jsim.run(J.parse_to_mps([JDV.ZERO] * n, EPS, RUN_QS))
        n_streamed, n_outcomes = len(streamed), len(outcomes)
        _replay_in_port(mp, streamed, rsvd, outcomes)
        tc = T.MBGKPCircuit.transpile([_dv(g) for g in gates])
        tc.fill()
        tsim = getattr(T, engine)(tc, ancilla_epsilon=EPS, rng_seed=3, svd_options=RUN_OPTS)
        tout, tsyn = tsim.run(T.parse_to_mps([TDV.ZERO] * n, EPS, RUN_QS, device="cpu"))
    return {"jax": (jout, [(int(x), int(z)) for x, z in jsyn]), "port": (tout, tsyn),
            "left": (len(streamed), len(rsvd), len(outcomes)),
            "n_streamed": n_streamed, "n_outcomes": n_outcomes}


@pytest.fixture(scope="module",
                params=[("1q", "Simulator", "rot"), ("G2", "Simulator", "rot"),
                        ("G2", "Simulator", "cz"), ("1q", "SimulatorAlt", "rot"),
                        ("G2", "SimulatorAlt", "rot")],
                ids=lambda p: "-".join(p[:2] if p[2] == tst._BS_DECOMP else p))
def run(request):
    return request.param, _parity_run(*request.param)


def test_run_replays_every_outcome_and_sketch(run):
    (name, engine, decomp), r = run
    assert r["left"] == (0, 0, 0)
    assert r["n_outcomes"] > 0
    if name == "G2":  # the interior BS of each two-qubit gadget streams
        assert r["n_streamed"] >= 2 * (3 if decomp == "cz" else 1)


def test_run_syndromes_match_jax(run):
    _, r = run
    assert r["port"][1] == r["jax"][1]
    assert all(isinstance(b, int) for s in r["port"][1] for b in s)


def test_run_final_mps_matches_jax(run):
    _, r = run
    _same_state(r["port"][0], r["jax"][0], RUN_TOL)


def test_run_logical_density_matches_jax(run):
    _, r = run
    (tout, tsyn), (jout, jsyn) = r["port"], r["jax"]
    rho = T.full_logical_density_mps(tout).numpy()
    _close(rho, J.full_logical_density_mps(jout), RUN_TOL)
    corr = T.syndrome_matrix(tsyn).numpy()
    rho = corr @ rho @ corr.conj().T
    jcorr = np.asarray(J.syndrome_matrix(jsyn))
    jrho = np.asarray(J.full_logical_density_mps(jout))
    jrho = jcorr @ jrho @ jcorr.conj().T
    _close(rho / np.trace(rho), jrho / np.trace(jrho), RUN_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_qubit_circuit_reaches_the_dv_state(seed):
    """The port alone at the JAX test's settings: syndrome-corrected
    logical density of [H, P] on |0> against the DV engine's state."""
    circuit = [tdv.H(0), tdv.P(0)]
    circ = T.MBGKPCircuit.transpile(circuit)
    circ.fill()
    sim = T.Simulator(circ, ancilla_epsilon=EPS, rng_seed=seed,
                      svd_options={"max_bond_dim": 24, "rel_err": 1e-2})
    qs = np.linspace(-20, 20, 500)
    mps, syn = sim.run(T.parse_to_mps([TDV.ZERO], EPS, qs, device="cpu"))
    rho = T.full_logical_density_mps(mps)
    corr = T.syndrome_matrix(syn).to(rho.dtype)
    rho = corr @ rho @ corr.mH
    want = TDVSim(circuit, device="cpu").run([TDV.ZERO])
    assert float(tqop.fidelity(want, rho / torch.trace(rho))) > 0.9
    again = T.Simulator(circ, ancilla_epsilon=EPS, rng_seed=seed,
                        svd_options={"max_bond_dim": 24, "rel_err": 1e-2})
    assert again.run(T.parse_to_mps([TDV.ZERO], EPS, qs, device="cpu"))[1] == syn
