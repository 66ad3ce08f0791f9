"""The port's batched GKP trajectory engine (``gkp/batched.BatchedGKP``,
the ``gkp/compiled`` helpers, ``pipelines/rb`` and ``pipelines/rb_batched``)
against the JAX package, on the CPU at x64.

Whole-engine runs use the production settings (op granularity, adaptive
trims, fused single and pair gadgets, host rank tracking) at d = 300 on
[-20, 20], 10 dB, bond cap 8, rel_err 1e-2, batch 2, on a circuit with H,
P, T (so a classically controlled P follows), CZ and SWAP. The JAX engine
draws inside vmapped programs, so its fused gadgets and its range finder
are wrapped in their modules' namespaces to record, per trajectory, the
drawn grid indices and the Gaussian sketches (``jax.debug.callback``);
the port takes the indices through ``force=`` and the sketches through
``ops.linalg._gaussian_sketch``. The JAX engine's per-trajectory angles
and Bell phases are float32 host arrays, whose cosines and phases its
programs evaluate in float32; the adapter hands them to it in float64
(the same float32-rounded values, as the port uses them), so both
evaluate them in float64. Tolerances: frames and syndromes exactly; the
syndrome-corrected logical densities at 1e-8 of their largest entry;
host arithmetic (coefficients, buckets, circuits, DV states, scores)
exactly or at 1e-12.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import quantum_computations_tpu.gkp.batched as jbatched
import quantum_computations_tpu.ops.linalg as jlinalg
import quantum_computations_tpu.ops.streamed as jst
import quantum_computations_tpu.cv.gates as jcg
from quantum_computations_tpu.config import SVDOptions as JOpts
from quantum_computations_tpu.dv import State as JDV, gates as jdv
from quantum_computations_tpu.gkp import MBGKPCircuit as JCircuit, db2eps
from quantum_computations_tpu.gkp.compiled import logical_coeffs as jlogical_coeffs
from quantum_computations_tpu.pipelines import rb as jrb, rb_batched as jrbb

import quantum_computations_tpu_torch.cv.gates as tcg
import quantum_computations_tpu_torch.gkp.batched as tbatched
import quantum_computations_tpu_torch.ops.linalg as tlinalg
import quantum_computations_tpu_torch.ops.streamed as tst
from quantum_computations_tpu_torch.dv import State as TDV, gates as tdv
from quantum_computations_tpu_torch.gkp import MBGKPCircuit as TCircuit
from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
from quantum_computations_tpu_torch.pipelines import rb as trb, rb_batched as trbb

RUN_TOL = 1e-8
QS = np.linspace(-20, 20, 300)
EPS = float(db2eps(10.0))
OPTS = {"max_bond_dim": 8, "rel_err": 1e-2}
BATCH = 2
CIRCUIT = ["H(0)", "CZ(0, 1)", "T(1)", "SWAP(0, 1)", "P(0)"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread per test process: the tier-1 run puts six
    test processes on the machine's cores, where torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(module, names):
    return [eval(n, {k: getattr(module, k) for k in ("H", "P", "T", "CZ", "SWAP", "I", "Pdg", "Tdg")})
            for n in names]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_logical_coeffs_and_trim_bucket_match_jax():
    states = list(TDV)
    got = logical_coeffs(states)
    want = jlogical_coeffs([JDV[s.name] for s in states])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for n in range(0, 140):
        assert tbatched.BatchedGKP._trim_bucket(n) == jbatched.BatchedGKP._trim_bucket(n)


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("n,depth", [(2, 8), (3, 5)])
def test_random_circ_matches_jax(seed, n, depth):
    """The same numpy seed gives the same gates and the same layers."""
    tgates, tcirc = trb.random_circ(n, depth, np.random.default_rng(seed))
    jgates, jcirc = jrb.random_circ(n, depth, np.random.default_rng(seed))
    assert [(type(g).__name__, g.indices) for g in tgates] == \
        [(type(g).__name__, g.indices) for g in jgates]
    assert tcirc.to_string() == jcirc.to_string()
    assert tcirc.depth() == jcirc.depth() == depth
    assert [g.__name__ for g in trb.GATE_LIST] == [g.__name__ for g in jrb.GATE_LIST]
    with pytest.raises(ValueError):
        trb.random_circ(1, depth, np.random.default_rng(seed))


def test_dv_state_and_scores_match_jax():
    tgates, _ = trb.random_circ(2, 8, np.random.default_rng(5))
    jgates, _ = jrb.random_circ(2, 8, np.random.default_rng(5))
    psi = trbb._dv_state_np(tgates, 2)
    _close(psi, jrbb._dv_state_np(jgates, 2), 1e-12)
    rng = np.random.default_rng(1)
    rho = rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4))
    rho = rho @ rho.conj().transpose(0, 2, 1)
    rho[1] *= np.nan  # dropped
    rho[2] *= -1      # trace <= 0: dropped
    got = trbb._score_batch(rho.real, rho.imag, psi, 10.0, 8)
    want = jrbb._score_batch(rho.real, rho.imag, psi, 10.0, 8)
    assert got[1] == want[1] == 2
    assert got[0] == want[0] and len(got[0]) == 1


# ---------------------------------------------------------------------------
# whole-engine runs, JAX recorded and replayed in the port
# ---------------------------------------------------------------------------

def _record_jax(mp):
    """Record, per trajectory, the JAX engine's fused-gadget indices (as
    force tuples), its randomized-SVD sketches and its streamed-split
    sketches, and the syndromes of every gadget.

    A vmapped ``jax.debug.callback`` runs once per trajectory, but not
    necessarily in trajectory order: each record carries its trajectory's
    PRNG key, and the wrapper of the engine step, which holds the step's
    key array, files the records in the order of its keys."""
    rec = {"single": [], "pair": [], "rsvd": [], "stream": [], "synd": []}
    pending = []
    real = {"fsg": jbatched.fused_single_gadget, "fpm": jbatched.fused_pair_measure2,
            "rrf": jlinalg.randomized_range_finder, "drv": jst._streamed_driver}
    Engine = jbatched.BatchedGKP
    steps = {name: getattr(Engine, name) for name in
             ("_single", "_op_fused_pair", "_op_bs", "_two")}

    def note(kind, key, *values):
        jax.debug.callback(lambda k, *v: pending.append((kind, np.asarray(k).tobytes(), v)),
                           key, *values)

    def file(keys):
        order = {np.asarray(k).tobytes(): n for n, k in enumerate(keys)}
        for kind, _, v in sorted(pending, key=lambda p: (p[0], order[p[1]])):
            rec[kind].append(np.array(v[0]) if kind == "rsvd" else tuple(int(x) for x in v))
        pending.clear()

    def fsg(tensors, idx, qs, bell, a1, a2, key, **kw):
        out, m1, m2, dg = real["fsg"](tensors, idx, qs, bell, a1, a2, key,
                                      diagnostics=True, **kw)
        note("single", key, dg["i"], dg["j"])
        return out, m1, m2

    def fpm(tensors, m, qs, a1, a2, key, **kw):
        out, m1, m2, dg = real["fpm"](tensors, m, qs, a1, a2, key, diagnostics=True, **kw)
        note("pair", key, *((dg["j"], dg["i"]) if dg["swapped"] else (dg["i"], dg["j"])))
        return out, m1, m2

    def rrf(A, l, q, key):
        note("rsvd", key, jax.random.normal(key, (A.shape[1], l), dtype=A.real.dtype))
        return real["rrf"](A, l, q, key)

    def driver(t1, t2, qs, warp_params, **kw):
        d, b = t1.shape[-2], t2.shape[-1]
        cap = min(kw["max_bond_dim"], t1.shape[-3] * d, d * b)
        l = min(cap + jlinalg.OVERSAMPLE, t1.shape[-3] * d, d * b)
        for key in kw["key"]:
            rec["stream"].append(np.array(jax.random.normal(key, (d, b, l), dtype=jnp.float64)))
        return real["drv"](t1, t2, qs, warp_params, **kw)

    def single(self, tensors, idx, meas_a2, syn_a1, syn_a2, bell_phase, keys, **kw):
        # the float32 angles and phases, evaluated in float64 (see the header)
        f64 = [np.asarray(x, np.float64) for x in (meas_a2, syn_a1, syn_a2, bell_phase)]
        out, synd = steps["_single"](self, tensors, idx, *f64, keys, **kw)
        rec["synd"].append(np.asarray(synd))
        file(keys)
        return out, synd

    def step(name):
        def run(self, *args, **kw):
            out = steps[name](self, *args, **kw)
            jax.block_until_ready(out)
            file(args[-1])
            return out
        return run

    def two(self, tensors, idx, mb2type, keys):
        out, synd = steps["_two"](self, tensors, idx, mb2type, keys)
        rec["synd"].append(np.asarray(synd))
        return out, synd

    for obj, name, new in (
            (jbatched, "fused_single_gadget", fsg), (jbatched, "fused_pair_measure2", fpm),
            (jlinalg, "randomized_range_finder", rrf),
            (jst, "_streamed_driver", driver), (Engine, "_single", single),
            (Engine, "_op_fused_pair", step("_op_fused_pair")), (Engine, "_op_bs", step("_op_bs")),
            (Engine, "_two", two)):
        mp.setattr(obj, name, new)
    return rec


def _replay_in_port(mp, rec):
    """Feed the recorded indices and sketches to the port in the order it
    asks for them, and record its syndromes."""
    real_fsg, real_fpm = tbatched.fused_single_gadget, tbatched.fused_pair_measure2
    real_single, real_two = tbatched.BatchedGKP._single, tbatched.BatchedGKP._two
    synd = []

    def forced(kind, batch):
        rows = [rec[kind].pop(0) for _ in range(batch)]
        return tuple(np.asarray(col) for col in zip(*rows))

    def fsg(tensors, idx, qs, bell, a1, a2, generator=None, **kw):
        return real_fsg(tensors, idx, qs, bell, a1, a2, generator,
                        force=forced("single", tensors[0].shape[0]), **kw)

    def fpm(tensors, m, qs, a1, a2, generator=None, **kw):
        return real_fpm(tensors, m, qs, a1, a2, generator,
                        force=forced("pair", tensors[0].shape[0]), **kw)

    def sketch(kind):
        def replay(*args):
            *shape, _, like = args
            o = rec[kind].pop(0)
            assert o.shape == tuple(shape), (o.shape, shape)
            return torch.from_numpy(o).to(like.dtype)
        return replay

    def single(self, *args, **kw):
        out, s = real_single(self, *args, **kw)
        synd.append(s)
        return out, s

    def two(self, *args, **kw):
        out, s = real_two(self, *args, **kw)
        synd.append(s)
        return out, s

    mp.setattr(tbatched, "fused_single_gadget", fsg)
    mp.setattr(tbatched, "fused_pair_measure2", fpm)
    mp.setattr(tlinalg, "_gaussian_sketch", sketch("rsvd"))
    mp.setattr(tst, "_stream_sketch", sketch("stream"))
    mp.setattr(tbatched.BatchedGKP, "_single", single)
    mp.setattr(tbatched.BatchedGKP, "_two", two)
    return synd


def _parity_run(seed, stream_threshold=None):
    """One JAX run with its draws recorded, and the port's run with them
    replayed. With ``stream_threshold`` both packages stream their BS
    splits above it, by one route (the direct rotation split)."""
    with pytest.MonkeyPatch.context() as mp:
        if stream_threshold is not None:
            mp.setattr(jcg, "_STREAM_THRESHOLD", stream_threshold)
            mp.setattr(tcg, "_STREAM_THRESHOLD", stream_threshold)
            mp.setattr(jst, "_BS_DECOMP", "rot")
            mp.setattr(tst, "_BS_DECOMP", "rot")
        rec = _record_jax(mp)
        jc = JCircuit.transpile(_gates(jdv, CIRCUIT), 2)
        jc.fill()
        jrunner = jbatched.BatchedGKP(QS, EPS, JOpts(**OPTS), adaptive=True,
                                      granularity="op")
        jt, jframes = jrunner.run_circuit(jc, jlogical_coeffs([JDV.ZERO] * 2),
                                          BATCH, rng_seed=seed)
        jre, jim = jrunner.readout(jt, jframes)
        counts = {k: len(v) for k, v in rec.items()}
        jsynd = list(rec["synd"])
        tsynd = _replay_in_port(mp, rec)
        tc = TCircuit.transpile(_gates(tdv, CIRCUIT), 2)
        tc.fill()
        runner = tbatched.BatchedGKP(QS, EPS, OPTS, adaptive=True, granularity="op",
                                     device="cpu")
        tt, tframes = runner.run_circuit(tc, logical_coeffs([TDV.ZERO] * 2),
                                         BATCH, rng_seed=seed)
        re, im = runner.readout(tt, tframes)
    return {"jax": (jt, jframes, np.asarray(jre) + 1j * np.asarray(jim), jsynd),
            "port": (tt, tframes, (re + 1j * im).numpy(), tsynd),
            "left": {k: len(v) for k, v in rec.items() if k != "synd"},
            "recorded": counts, "runner": runner}


RUNS = {"materialised": {}, "streamed": {"stream_threshold": 1}}


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    return request.param, _parity_run(seed=7, **RUNS[request.param])


def test_run_replays_every_draw_and_sketch(run):
    name, r = run
    assert r["left"] == {"single": 0, "pair": 0, "rsvd": 0, "stream": 0}
    rec, counts = r["recorded"], r["runner"].counts
    # 8 single gadgets (the controlled P among them), 4 pair measures
    assert rec["single"] == 8 * BATCH and rec["pair"] == 4 * BATCH
    if name == "materialised":
        assert rec["rsvd"] > 0 and rec["stream"] == 0
        assert counts["bs"] == 4 and not counts["bs_streamed"]
    else:
        assert rec["stream"] == 4 * BATCH
        assert counts["bs_streamed"] == 4 and not counts["bs"]


def test_run_frames_and_syndromes_match_jax(run):
    _, r = run
    jt, jframes, _, jsynd = r["jax"]
    tt, tframes, _, tsynd = r["port"]
    np.testing.assert_array_equal(tframes, jframes)
    assert len(tsynd) == len(jsynd) == 10
    for a, b in zip(tsynd, jsynd):
        np.testing.assert_array_equal(a, b)


def test_run_shapes_and_logical_density_match_jax(run):
    _, r = run
    jt, _, jrho, _ = r["jax"]
    tt, _, trho, _ = r["port"]
    assert [tuple(t.shape) for t in tt] == [t.shape for t in jt]
    assert trho.shape == (BATCH, 4, 4)
    for a, b in zip(trho, jrho):
        _close(a, b, RUN_TOL)


# ---------------------------------------------------------------------------
# rank tracking against full fetches (the port alone)
# ---------------------------------------------------------------------------

def _production(track: bool, seed: int):
    """The port alone on a coarser grid (the trims, not the physics, are
    under test)."""
    circuit = TCircuit.transpile(_gates(tdv, CIRCUIT), 2)
    circuit.fill()
    runner = tbatched.BatchedGKP(np.linspace(-12, 12, 128), EPS, OPTS, adaptive=True,
                                 granularity="op", track_ranks=track, device="cpu")
    tensors, frames = runner.run_circuit(circuit, logical_coeffs([TDV.ZERO] * 2),
                                         3, rng_seed=seed)
    return [t.numpy() for t in tensors], frames, runner


@pytest.mark.parametrize("threshold", [None, 1], ids=["materialised", "streamed"])
def test_rank_tracking_matches_full_fetch(monkeypatch, threshold):
    """Host-tracked ranks reproduce the full-fetch trims exactly: the same
    shapes, values and frames, with no full fetch when tracking."""
    if threshold is not None:
        monkeypatch.setattr(tcg, "_STREAM_THRESHOLD", threshold)
    t_on, f_on, r_on = _production(True, 11)
    t_off, f_off, r_off = _production(False, 11)
    assert [t.shape for t in t_on] == [t.shape for t in t_off]
    for a, b in zip(t_on, t_off):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(f_on, f_off)
    assert r_on.counts["rank_fetch"] == 0 and r_off.counts["rank_fetch"] > 0
    assert r_on.counts["trim"] > 0
    assert (r_on.counts["bs_streamed"] > 0) == (threshold is not None)


def test_trim_frees_the_untrimmed_storage():
    runner = tbatched.BatchedGKP(QS, EPS, OPTS, adaptive=True, granularity="op",
                                 device="cpu")
    t = [torch.zeros(2, 1, 5, 8, dtype=torch.complex128),
         torch.zeros(2, 8, 5, 1, dtype=torch.complex128)]
    t[0][..., :3] = 1.0
    t[1][:, :3] = 1.0
    out = runner._trim_tensors(t)
    assert [tuple(x.shape) for x in out] == [(2, 1, 5, 4), (2, 4, 5, 1)]
    for x in out:
        assert x.is_contiguous()
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
    assert runner.counts["rank_fetch"] == 1


# ---------------------------------------------------------------------------
# the engine's entry points alone
# ---------------------------------------------------------------------------

def test_init_tensors_and_readout_match_jax():
    states = [TDV.PLUS, TDV.T]
    runner = tbatched.BatchedGKP(QS, EPS, OPTS, device="cpu")
    jrunner = jbatched.BatchedGKP(QS, EPS, JOpts(**OPTS))
    tt = runner.init_tensors(logical_coeffs(states), 3)
    jt = jrunner.init_tensors(jlogical_coeffs([JDV[s.name] for s in states]), 3)
    for a, b in zip(tt, jt):
        _close(a.numpy(), b, 1e-12)
    frames = np.array([[[0, 0], [1, 0]], [[1, 1], [0, 1]], [[1, 0], [1, 1]]])
    re, im = runner.readout(tt, frames)
    jre, jim = jrunner.readout(jt, frames)
    _close(re.numpy() + 1j * im.numpy(), np.asarray(jre) + 1j * np.asarray(jim), 1e-10)


def test_sample_depth_batched_rows_follow_the_reference_schema():
    runner = tbatched.BatchedGKP(np.linspace(-20, 20, 128), EPS, OPTS,
                                 adaptive=True, granularity="op", device="cpu")
    stats = {}
    rows = trbb.sample_depth_batched(runner, 10.0, 2, 3, 2, np.random.default_rng(0), stats)
    assert len(rows) == 4 and stats == {"attempted": 4, "dropped": 0}
    for row in rows:
        assert set(row) == {"db", "depth", "fidelity", "purity", "trace"}
        assert row["db"] == 10.0 and row["depth"] == 2
        assert 0.0 < row["trace"] <= 1.0 + 1e-9 and np.isfinite(row["fidelity"])


@pytest.mark.parametrize("granularity,fused_single,fused_pair", [
    ("op", False, False), ("op", True, False), ("op", False, True),
    ("gadget", False, False), ("gadget", True, True)])
def test_split_op_alternatives_reach_the_dv_state(granularity, fused_single, fused_pair):
    """The paths the constructor selects run the JAX test's circuit and
    seed (tests/test_batched_gkp.py::test_op_granularity_matches_dv) to
    finite densities near the DV state (a mean fidelity above 0.5, where a
    random state gives 0.25; the split-op gadgets' parity with the JAX
    package is the next test)."""
    gates = [tdv.H(0), tdv.CZ(0, 1)]
    circuit = TCircuit.transpile(gates, 2)
    circuit.fill()
    runner = tbatched.BatchedGKP(QS, EPS, OPTS, adaptive=True, granularity=granularity,
                                 fused_single=fused_single, fused_pair=fused_pair,
                                 device="cpu")
    tensors, frames = runner.run_circuit(circuit, logical_coeffs([TDV.ZERO] * 2), 8,
                                         rng_seed=5)
    re, im = runner.readout(tensors, frames)
    rhos = (re + 1j * im).numpy()
    assert np.all(np.isfinite(rhos))
    psi = trbb._dv_state_np(gates, 2)
    fids = [float(np.real(psi.conj() @ r @ psi)) for r in rhos]
    assert np.mean(fids) > 0.5, fids
    assert bool(runner.counts["fused_single"]) == fused_single
    assert any(k.startswith("fused_pair") for k in runner.counts) == fused_pair
    assert runner.counts["rank_fetch"] > 0  # no tracking off the production path


def test_split_op_gadgets_match_jax(monkeypatch):
    """The split-op gadgets (``gkp/compiled``: Bell insertion, BS splits,
    homodynes) on a two-mode chain against the JAX package's, eagerly,
    with the exact SVD and the JAX homodynes' outcomes forced in the port:
    a CZ macronode, then a P gadget. Syndromes exactly; the logical
    density at 1e-8. (A whole split-op engine run adds little more and
    its JAX compiles dominate the parallel tier-1 run.)"""
    from quantum_computations_tpu.cv import MPS as JMPS
    from quantum_computations_tpu.gkp import MB2Type as JMB2, full_logical_density_mps
    from quantum_computations_tpu.gkp import parse_to_mps
    import quantum_computations_tpu.gkp.compiled as jcompiled
    import quantum_computations_tpu_torch.gkp.compiled as tcompiled
    from quantum_computations_tpu_torch.config import SVDOptions as TOpts
    from quantum_computations_tpu_torch.gkp.gates import MB2Type
    from quantum_computations_tpu_torch.gkp.utils import logical_density_batch

    qs = np.linspace(-10, 10, 64)
    opts = dict(OPTS, svd_method="full")
    p_angles = (0.0, float(np.arctan(2)))
    outcomes = []
    real_mq = jcg.Mq.apply

    def mq(self, mps, **kw):
        out = real_mq(self, mps, **kw)
        outcomes.append(int(np.argmin(np.abs(qs - float(out.result)))))
        return out

    monkeypatch.setattr(jcg.Mq, "apply", mq)
    jm = JMPS(qs, list(parse_to_mps([JDV.PLUS, JDV.ZERO], EPS, qs).tensors))
    jsyn = jcompiled._two_mode_gadget(jm, 0, JMB2.CZ, False, EPS, JOpts(**opts),
                                      jax.random.PRNGKey(3))
    jsyn1 = jcompiled._single_gadget(jm, 1, p_angles, p_angles, 1.0, EPS,
                                     JOpts(**opts), jax.random.PRNGKey(4))
    assert len(outcomes) == 6
    draws = iter(outcomes)
    monkeypatch.setattr(tcompiled, "_draw",
                        lambda dist, forced, generator: torch.tensor([next(draws)]))
    tt = [torch.from_numpy(np.array(t))[None]
          for t in parse_to_mps([JDV.PLUS, JDV.ZERO], EPS, qs).tensors]
    bell = tcompiled.bell_vectors(tcompiled.gkp_basis(torch.from_numpy(qs), EPS),
                                  np.ones(1), torch.complex128)
    tt, tsyn = tcompiled._two_mode_gadget(tt, 0, MB2Type.CZ, bell, TOpts(**opts), None, qs)
    tt, tsyn1 = tcompiled._single_gadget(tt, 1, p_angles, p_angles, bell, TOpts(**opts),
                                         None, qs)
    assert tsyn.tolist() == [[[int(x), int(z)] for x, z in jsyn]]
    assert tsyn1.tolist() == [[int(x) for x in jsyn1]]
    assert [tuple(t.shape[1:]) for t in tt] == [t.shape for t in jm.tensors]
    _close(logical_density_batch(tt, qs)[0].numpy(), full_logical_density_mps(jm), RUN_TOL)


def test_gadget_granularity_equals_op_granularity():
    """With the exact SVD (no sketches) both granularities draw the same
    outcomes in the same order; the op path only trims zero columns
    between ops, so on a CZ macronode, a T and its controlled P the two
    give the same state, up to the macronode's homodyne angles,
    float32-rounded on the op path (as in the JAX package) and not on the
    gadget path: 1e-6."""
    qs = np.linspace(-10, 10, 64)
    opts = dict(OPTS, svd_method="full")
    circuit = TCircuit.transpile(_gates(tdv, ["CZ(0, 1)", "T(1)"]), 2)
    circuit.fill()
    out = []
    for granularity in ("op", "gadget"):
        runner = tbatched.BatchedGKP(qs, EPS, opts, adaptive=True, granularity=granularity,
                                     fused_single=False, fused_pair=False, device="cpu")
        tensors, frames = runner.run_circuit(circuit, logical_coeffs([TDV.ZERO] * 2), 2,
                                             rng_seed=3)
        re, im = runner.readout(tensors, frames)
        out.append((frames, (re + 1j * im).numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for a, b in zip(out[1][1], out[0][1]):
        _close(a, b, 1e-6)


def test_rb_batched_main_writes_the_reference_schemas(tmp_path):
    """``main`` writes the .dat rows and the .meta.json cells with the JAX
    package's keys; ``config_cli`` parses the same flags."""
    from quantum_computations_tpu.pipelines.common import config_cli as jcli
    from quantum_computations_tpu_torch.pipelines.common import config_cli, write_data
    path = tmp_path / "rb.dat"
    config = trbb.RBBatchedConfig(dbs="10", depths="2", num_samples=2, batch=2,
                                  grid_points=64, grid_span=12.0, max_bond_dim=8,
                                  data_file=str(path), device="cpu")
    data = trbb.main(config)
    rows = json.loads(path.read_text())
    assert rows == data and len(rows) == 2
    assert all(set(r) == {"db", "depth", "fidelity", "purity", "trace"} for r in rows)
    meta = json.loads((tmp_path / "rb.dat.meta.json").read_text())
    assert [set(m) for m in meta] == [{
        "db", "depth", "samples", "batch", "attempted", "dropped", "drop_rate",
        "seconds", "sec_per_traj", "mean_fidelity", "sem_fidelity", "engine"}]
    assert meta[0]["engine"]["fused_single"] and meta[0]["engine"]["rank_track"]
    with pytest.raises(FileExistsError):
        trbb.main(config)
    argv = ["--dbs", "5,6", "--batch", "4", "--overwrite"]
    got = config_cli(trbb.RBBatchedConfig, argv)
    want = jcli(jrbb.RBBatchedConfig, argv)
    assert got.threads == 1  # the JAX package's QCT_RB_THREADS
    assert {k: v for k, v in vars(got).items() if k not in ("device", "threads")} == vars(want)
    write_data(str(path), [{"x": np.float32(0.5)}])
    assert json.loads(path.read_text()) == [{"x": 0.5}]
