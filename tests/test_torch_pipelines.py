"""The port's research pipelines (``pipelines/{circuits, grover, rb,
grover_batched, grover_compiled, rb_compiled, analysis, tomography,
clifford_fidelity}``) against the JAX package, on the CPU at x64.

Host arithmetic (gate lists, circuits, fits, summaries, class searches)
is held exactly; tomography at 1e-10; the GKP encodings and their
fidelities at 1e-8; the eager RB sample at 1e-8 with the JAX run's
homodyne outcomes and sketches replayed (``test_torch_gkp.py``'s
harness). The ``.dat`` and ``.meta.json`` files of every pipeline are
held to the JAX pipeline's keys and value types: the port's pipelines run
at tiny sizes (d = 96, bond cap 4), the JAX ones with their engines
replaced by stubs of the right shapes (their writers are compared).
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

import quantum_computations_tpu.gkp.batched as jbatched
import quantum_computations_tpu.gkp.compiled as jcompiled
from quantum_computations_tpu.dv import gates as jdv
from quantum_computations_tpu.gkp import db2eps
from quantum_computations_tpu.pipelines import analysis as jan, circuits as jcc
from quantum_computations_tpu.pipelines import clifford_fidelity as jcf, grover as jgr
from quantum_computations_tpu.pipelines import grover_batched as jgb, grover_compiled as jgc
from quantum_computations_tpu.pipelines import rb as jrb, rb_compiled as jrbc
from quantum_computations_tpu.pipelines import tomography as jtomo
from quantum_computations_tpu.pipelines.common import config_cli as jcli

from quantum_computations_tpu_torch.dv import Simulator as TDVSim, gates as tdv, qop as tqop
from quantum_computations_tpu_torch.pipelines import analysis as tan, circuits as tcc
from quantum_computations_tpu_torch.pipelines import clifford_fidelity as tcf, grover as tgr
from quantum_computations_tpu_torch.pipelines import grover_batched as tgb, grover_compiled as tgc
from quantum_computations_tpu_torch.pipelines import rb as trb, rb_compiled as trbc
from quantum_computations_tpu_torch.pipelines import tomography as ttomo
from quantum_computations_tpu_torch.pipelines.common import config_cli

from test_torch_gkp import _record_jax as _record_eager, _replay_in_port as _replay_eager

EPS = float(db2eps(10.0))
RUN_TOL = 1e-8
TINY = dict(grid_points=96, grid_span=12.0, max_bond_dim=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread and one BLAS thread per test process: the
    tier-1 run puts six test processes on the machine's cores, and the
    OpenBLAS behind JAX's decompositions otherwise spins one thread per
    core in each (a tiny SVD loads it first, so that the limit reaches
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jnp.linalg.svd(jnp.eye(2))
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _names(gates):
    return [(type(g).__name__, list(g.indices)) for g in gates]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


# ---------------------------------------------------------------------------
# circuits and the Grover builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tagged", [[3, 6], [0, 4], [2, 7]])
def test_grover_circuits_match_jax_and_the_dv_result(tagged):
    assert _names(tcc.oracle(tagged)) == _names(jcc.oracle(tagged))
    assert _names(tcc.grover(tcc.oracle(tagged))) == _names(jcc.grover(jcc.oracle(tagged)))
    circ, init = tgr.grover(tagged)
    jcirc, jinit = jgr.grover(tagged)
    assert _names(circ) == _names(jcirc) and [s.name for s in init] == [s.name for s in jinit]
    assert not any(isinstance(g, tdv.CX) for g in circ)
    probs = np.abs(TDVSim(circ, device="cpu").run(init).numpy()) ** 2
    np.testing.assert_allclose(probs[tagged], 0.5, atol=1e-12)
    # the DV recipe: the three-qubit Grover iteration with its Inserts
    state = TDVSim(tcc.grover(tcc.oracle(tagged)), device="cpu").run()
    np.testing.assert_allclose(np.abs(state.numpy()[tagged]) ** 2, 0.5, atol=1e-12)


def test_circuit_helpers_match_jax():
    assert _names(tcc.ccz()) == _names(jcc.ccz()) == _names(tcc.CCZ)
    circ = [tdv.CX(0, 1), tdv.T(2), tdv.SWAP(1, 2)]
    jcirc = [jdv.CX(0, 1), jdv.T(2), jdv.SWAP(1, 2)]
    assert _names(tcc.relabel(circ, {0: 2, 2: 0})) == _names(jcc.relabel(jcirc, {0: 2, 2: 0}))
    assert _names(circ) == [("CX", [0, 1]), ("T", [2]), ("SWAP", [1, 2])]  # not modified
    with pytest.raises(ValueError):
        tcc.relabel(circ, {0: 1})
    with pytest.raises(NotImplementedError):
        tcc.oracle([1, 2])
    for n in (0, 5, 6):
        assert tcc.int2tag(n, 3) == jcc.int2tag(n, 3)
        assert tcc.tag2int(tcc.int2tag(n, 3)) == n
    tcirc, tinit = tgr.test_circuit()
    jcirc, jinit = jgr.test_circuit()
    assert _names(tcirc) == _names(jcirc) and [s.name for s in tinit] == [s.name for s in jinit]


def test_success_probability_and_summaries_match_jax():
    rng = np.random.default_rng(2)
    data = []
    for eps in (EPS, EPS, 0.2, 0.2, 0.2):
        a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
        rho = a @ a.conj().T / 9
        data.append({"epsilon": eps, "rho_real": rho.real.tolist(),
                     "rho_imag": rho.imag.tolist()})
        assert tgr.success_probability(rho, [0, 4]) == jgr.success_probability(rho, [0, 4])
    assert tgb.summarize(data, [0, 4]) == jgb.summarize(data, [0, 4])
    assert tgc.summarize(data, [2, 7]) == jgc.summarize(data, [2, 7])


# ---------------------------------------------------------------------------
# the eager RB sample, JAX's draws replayed
# ---------------------------------------------------------------------------

def test_rb_sample_depth_matches_jax_with_outcomes_forced():
    kw = dict(grid_points=128, max_bond_dim=4)
    with pytest.MonkeyPatch.context() as mp:
        streamed, rsvd, outcomes = _record_eager(mp)
        want = jrb.sample_depth(10.0, 2, 1, 5, **kw)
        n_outcomes = len(outcomes)
        _replay_eager(mp, streamed, rsvd, outcomes)
        got = trb.sample_depth(10.0, 2, 1, 5, device="cpu", **kw)
    assert n_outcomes > 0 and not outcomes and not rsvd and not streamed
    assert len(got) == len(want) == 1
    (g,), (w,) = got, want
    assert set(g) == set(w) == {"db", "depth", "fidelity", "purity", "trace"}
    assert (g["db"], g["depth"]) == (w["db"], w["depth"])
    for k in ("fidelity", "purity", "trace"):
        assert abs(g[k] - w[k]) <= RUN_TOL, (k, g[k], w[k])


def test_sample_depth_compiled_gives_valid_high_fidelity_samples():
    """The JAX package's slow ``test_rb_compiled.py`` pair, sized small:
    one depth-2 circuit at 11 dB, four trajectories, grid 256, cap 8 (the
    JAX test's seed); valid rows and a mean fidelity above 0.6."""
    rows = trbc.sample_depth_compiled(11.0, 2, num_circuits=1, traj_per_circuit=4,
                                      rng_seed=1, grid_points=256, max_bond_dim=8,
                                      device="cpu")
    assert len(rows) == 4
    for r in rows:
        assert set(r) == {"db", "depth", "fidelity", "purity"}
        assert r["db"] == 11.0 and r["depth"] == 2
        assert -0.01 <= r["fidelity"] <= 1.05 and -0.01 <= r["purity"] <= 1.05
    assert np.mean([r["fidelity"] for r in rows]) > 0.6


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def test_analysis_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    rb_rows = [{"db": db, "depth": m, "purity": float(rng.uniform(0.5, 1)),
                "fidelity": float(0.7 * p ** m + 0.25 + rng.normal(scale=0.01))}
               for db, p in ((5.833, 0.9), (10.0, 0.97)) for m in (4, 8, 15, 20)
               for _ in range(3)]
    path = tmp_path / "rb.dat"
    path.write_text(json.dumps(rb_rows))
    assert tan.load_dat(str(path)) == jan.load_dat(str(path)) == rb_rows
    assert tan.rb_fit(rb_rows) == jan.rb_fit(rb_rows)
    grover_rows = []
    for db in (6.667, 10.0, 15.0):
        for _ in range(3):
            a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
            rho = a @ a.conj().T / 9
            grover_rows.append({"epsilon": float(db2eps(db)), "rho_real": rho.real.tolist(),
                                "rho_imag": rho.imag.tolist()})
    e = grover_rows[0]
    assert tan.grover_success(e, [2, 7]) == jan.grover_success(e, [2, 7])
    assert tan.grover_success_by_db(grover_rows, [2, 7]) == \
        jan.grover_success_by_db(grover_rows, [2, 7])
    assert tan.grover_success_curve(grover_rows, [2, 7]) == \
        jan.grover_success_curve(grover_rows, [2, 7])
    for db in (5.0, 8.0, 10.0, 12.5, 20.0):
        assert tan.analytical_gate_error(db, 2) == jan.analytical_gate_error(db, 2)
        assert tan.grover_error_estimate(db) == jan.grover_error_estimate(db)
    cliff = [{"db": db, "clifford_index": i, "fidelities": rng.uniform(size=16).tolist()}
             for db in (5.0, 5.833) for i in range(4)]
    assert tan.clifford_summary(cliff) == jan.clifford_summary(cliff)


# ---------------------------------------------------------------------------
# tomography
# ---------------------------------------------------------------------------

def _channels():
    p = 0.25
    depol = [np.sqrt(1 - p) * tqop.IDTY] + [np.sqrt(p / 3) * P for P in tqop.PAULIS]
    return {"identity": ([np.identity(2)], 1, {}),
            "depolarizing": (depol, 1, dict(normalised=True, strict=True)),
            "cz": ([np.asarray(tqop.CZ)], 2, {})}


@pytest.mark.parametrize("name", ["identity", "depolarizing", "cz"])
def test_tomography_matches_jax(name):
    """The test_pipelines.py channels: the eager entry point's Kraus operators
    and weights, and the device core (``fit_superoperator``,
    ``chi_from_superoperator``, ``kraus_from_chi``) against JAX's jitted
    kernels, at 1e-10."""
    Ks, N, kw = _channels()[name]
    chan = ttomo.quantum_channel(Ks, ket_input=True, return_input=True)
    jchan = jtomo.quantum_channel(Ks, ket_input=True, return_input=True)
    got = ttomo.process_tomography(chan, N, **kw)
    want = jtomo.process_tomography(jchan, N, **kw)
    if kw.get("normalised"):
        _close(got[0], want[0], 1e-10)
        got, want = got[1], want[1]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, 1e-10)
    inputs, outputs = ttomo.eval_process(chan, N, True)
    basis = ttomo.pauli_basis(N)
    M = ttomo.fit_superoperator(np.stack(inputs), np.stack(outputs), device="cpu")
    jM = jtomo.fit_superoperator(jnp.asarray(np.stack(inputs)), jnp.asarray(np.stack(outputs)))
    _close(M.numpy(), jM, 1e-10)
    _close(M.numpy(), ttomo.process_matrix(inputs, outputs), 1e-10)
    chi = ttomo.chi_from_superoperator(M, basis, device="cpu")
    _close(chi.numpy(), jtomo.chi_from_superoperator(jM, jnp.asarray(basis)), 1e-10)
    D, K = ttomo.kraus_from_chi(chi, basis, device="cpu")
    jD, jK = jtomo.kraus_from_chi(jnp.asarray(chi.numpy()), jnp.asarray(basis))
    _close(D.numpy(), jD, 1e-10)
    # each eigenvector is fixed up to a phase: compare the channels they build
    rho = np.outer(np.arange(1, 2**N + 1), np.arange(1, 2**N + 1)).astype(complex)
    rho /= np.trace(rho)
    apply = lambda d, k: sum(w * a @ rho @ a.conj().T for w, a in zip(d, k))  # noqa: E731
    _close(apply(D.numpy(), K.numpy()), apply(np.asarray(jD), np.asarray(jK)), 1e-10)


def test_tomography_bases_match_jax():
    for N in (1, 2):
        np.testing.assert_array_equal(ttomo.pauli_basis(N), jtomo.pauli_basis(N))
        np.testing.assert_array_equal(ttomo.probe_kets(N), jtomo.probe_kets(N))
        np.testing.assert_array_equal(ttomo.computational_kets(N), jtomo.computational_kets(N))
        for a, b in zip(ttomo.state_basis(N), jtomo.state_basis(N)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ttomo.process_matrix([np.eye(2)] * 2, [np.eye(2)] * 2)  # under-sampled
    assert ttomo.krauss_operators is ttomo.kraus_operators


# ---------------------------------------------------------------------------
# Clifford-encoding fidelity
# ---------------------------------------------------------------------------

def test_compute_cliffords_gives_the_720_classes_of_jax_in_order():
    reps = tcf.compute_cliffords()
    jreps = jcf.compute_cliffords()
    assert len(reps) == len(jreps) == 720
    for a, b in zip(reps, jreps):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    paulis = tcf.compute_paulis()
    for a, b in zip(paulis, jcf.compute_paulis()):
        np.testing.assert_array_equal(a, b)
    ket = np.array([1.0, 0, 0, 0])
    res = sum(abs(ket @ p @ c @ ket) ** 2 for c in reps for p in paulis)
    assert np.isclose(res / (720 * 16), 0.25, atol=1e-10)
    for U in reps[:20]:
        np.testing.assert_array_equal(tcf.symplectic_rep(U, paulis),
                                      jcf.symplectic_rep(U, jcf.compute_paulis()))


def test_encode_ket_and_job_match_jax():
    qs = np.linspace(-15, 15, 300)
    rng = np.random.default_rng(8)
    kets = [np.array([1.0, 0, 0, 1.0]) / np.sqrt(2),
            rng.normal(size=4) + 1j * rng.normal(size=4),
            np.array([0.6, 0.8j]),
            rng.normal(size=8) * (rng.uniform(size=8) > 0.4)]
    for ket in kets:
        got = tcf.encode_ket(qs, EPS, ket, device="cpu")
        want = jcf.encode_ket(qs, EPS, ket)
        assert got.shape() == tuple(t.shape for t in want.tensors)
        for a, b in zip(got.to_numpy(), want.tensors):
            _close(a, b, RUN_TOL)
    reps, paulis = tcf.compute_cliffords(), tcf.compute_paulis()
    for idx in (0, 1, 300, 719):
        got = tcf.job(qs, 10.0, reps[idx], idx, paulis, device="cpu")
        want = jcf.job(qs, 10.0, reps[idx], idx, paulis)
        assert got.keys() == want.keys() and got["clifford_index"] == idx
        assert got["db"] == want["db"] and len(got["fidelities"]) == 16
        _close(got["fidelities"], want["fidelities"], RUN_TOL)
        assert got["fidelities"][0] > 0.9  # the identity: the encoding fidelity


# ---------------------------------------------------------------------------
# the pipelines' files and configs
# ---------------------------------------------------------------------------

def _schema(x):
    """Keys and value types of a JSON document."""
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    if isinstance(x, list):
        return sorted({json.dumps(_schema(v), sort_keys=True) for v in x})
    return type(x).__name__


def _stub_rho(n_qubits, batch=None):
    rho = np.eye(2**n_qubits) / 2**n_qubits
    return rho if batch is None else np.stack([rho] * batch)


def _run_jax_pipelines(mp, tmp_path):
    """Each JAX pipeline at the port test's settings, its engine stubbed."""
    mp.setattr(jgr, "run_simulation", lambda sim, init: _stub_rho(3).astype(complex))
    mp.setattr(jgb, "setup_compile_cache", lambda: None)
    mp.setattr(jbatched.BatchedGKP, "run_circuit",
               lambda self, c, coeffs, n, rng_seed=0: (None, np.zeros((n, 3, 2), np.int32)))
    mp.setattr(jbatched.BatchedGKP, "readout",
               lambda self, t, frames: (_stub_rho(3, len(frames)), 0 * _stub_rho(3, len(frames))))
    mp.setattr(jcompiled.CompiledGKP, "batched_readout",
               lambda self, coeffs, n, rng_seed=None: (
                   np.zeros((n, 3, 2), np.int32), _stub_rho(3, n), 0 * _stub_rho(3, n)))
    mp.setattr(jrb, "run_simulation", lambda sim, init: _stub_rho(2).astype(complex))
    mp.setattr(jrbc, "make_scored_trajectory",
               lambda prog, dv, init: lambda key: (jnp.asarray(0.5), jnp.asarray(0.25)))
    out = {}
    for name, module, config, kw in _pipelines(tmp_path / "jax"):
        module.main(config, **kw)
        out[name] = _read(config.data_file)
    return out


def _pipelines(root, port=False):
    root.mkdir(exist_ok=True)
    dev = {"device": "cpu"} if port else {}
    tiny = {k: v for k, v in TINY.items() if k != "grid_span"}
    gr, gb, gc = (tgr, tgb, tgc) if port else (jgr, jgb, jgc)
    rb, rbc = (trb, trbc) if port else (jrb, jrbc)
    return [
        ("grover", gr, gr.GroverConfig(db_min=10.0, db_max=10.0, db_points=1, db_skip=0,
                                       repeats=1, data_file=str(root / "g.dat"), **TINY, **dev),
         {"progress": False}),
        ("grover_batched", gb, gb.GroverBatchedConfig(
            dbs="10.0", trajectories=2, batch=2, data_file=str(root / "gb.dat"), **TINY, **dev),
         {}),
        ("grover_compiled", gc, gc.GroverCompiledConfig(
            dbs="10.0", traj_per_db=2, data_file=str(root / "gc.dat"), **TINY, **dev), {}),
        ("rb", rb, rb.RBConfig(db_slice="0:1", db_repeats=1, depths="2", num_samples=1,
                               data_file=str(root / "rb.dat"), **TINY, **dev), {}),
        ("rb_compiled", rbc, rbc.RBCompiledConfig(
            dbs="10.0", depths="2", num_circuits=1, traj_per_circuit=2,
            data_file=str(root / "rbc.dat"), **tiny, **dev), {}),
    ]


def _read(path):
    out = {"dat": json.loads(open(path).read())}
    if os.path.exists(path + ".meta.json"):
        out["meta"] = json.loads(open(path + ".meta.json").read())
    return out


def test_pipeline_files_follow_the_jax_schemas(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        want = _run_jax_pipelines(mp, tmp_path)
    for name, module, config, kw in _pipelines(tmp_path / "port", port=True):
        data = module.main(config, **kw)
        got = _read(config.data_file)
        assert got["dat"] == json.loads(json.dumps(data, default=float)), name
        assert got.keys() == want[name].keys(), name
        for part in got:
            assert _schema(got[part]) == _schema(want[name][part]), (name, part)
        if name.startswith("grover"):
            for row in got["dat"]:
                rho = np.array(row["rho_real"]) + 1j * np.array(row["rho_imag"])
                assert rho.shape == (8, 8) and 0.5 < np.trace(rho).real <= 1 + 1e-9
        with pytest.raises(FileExistsError):
            module.main(config, **kw)
    assert got["dat"][0].keys() == {"db", "depth", "fidelity", "purity"}


@pytest.mark.parametrize("module,jmodule,name", [
    (tgr, jgr, "GroverConfig"), (tgb, jgb, "GroverBatchedConfig"),
    (tgc, jgc, "GroverCompiledConfig"), (trb, jrb, "RBConfig"),
    (trbc, jrbc, "RBCompiledConfig"), (tcf, jcf, "CliffordConfig")])
def test_configs_and_cli_match_jax(module, jmodule, name):
    """The same defaults and flags; the port adds ``device`` (default
    ``cuda``), and ``GroverBatchedConfig`` ``threads`` (default 1, the JAX
    package's ``QCT_GROVER_THREADS``)."""
    for argv in ([], ["--overwrite", "--rng-seed", "7"] if name != "CliffordConfig"
                 else ["--overwrite", "--num-cliffords", "7"]):
        got = vars(config_cli(getattr(module, name), argv))
        want = vars(jcli(getattr(jmodule, name), argv))
        assert got.pop("device") == "cuda"
        if name == "GroverBatchedConfig":
            assert got.pop("threads") == 1
        assert got == want
