"""The port's whole-circuit GKP engine (``gkp/compiled.CompiledGKP``, its
device syndrome and frame arithmetic) and the batched engine on the
Grover test circuit, against the JAX package on the CPU at x64.

The JAX program runs as ``jit(vmap(trajectory))`` over two PRNG keys, with
the initial tensors batched too, so that every split sees traced values
and keeps its static cap (as in production). Its homodyne outcomes, its
randomized-SVD sketches and the angles and Bell coefficients of every
single-mode gadget are recorded per trajectory by ``jax.debug.callback``:
each record carries its trajectory's tag and a sequence number fixed at
trace time, since the callbacks of a jitted program do not arrive in
program order. The port takes the outcomes through ``_draw`` and the
sketches through ``ops.linalg._gaussian_sketch``.

At d = 160 and bond cap 8 the macronode's inner split meets a flat
spectrum at the cap (s9/s8 ~ 0.996), where the two packages' range
finders keep rank-8 subspaces that differ at ~1e-8 however the sketches
are replayed; the runs at cap 8 therefore split with the exact SVD
(``svd_method="full"``), and one run of the Grover test circuit at cap 16
holds the randomized path with JAX's sketches replayed. Tolerances:
frames, syndromes and gadget parameters exactly (float64); contracted
states and syndrome-corrected logical densities at 1e-8 of their largest
entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

import quantum_computations_tpu.gkp.batched as jbatched
import quantum_computations_tpu.gkp.compiled as jcompiled
import quantum_computations_tpu.ops.linalg as jlinalg
from quantum_computations_tpu.config import SVDOptions as JOpts
from quantum_computations_tpu.dv import State as JDV, gates as jdv
from quantum_computations_tpu.gkp import MBGKPCircuit as JCircuit
from quantum_computations_tpu.gkp import db2eps, parse_to_mps as jparse
from quantum_computations_tpu.pipelines import grover as jgrover

import quantum_computations_tpu_torch.gkp.batched as tbatched
import quantum_computations_tpu_torch.gkp.compiled as tcompiled
import quantum_computations_tpu_torch.ops.linalg as tlinalg
from quantum_computations_tpu_torch.dv import State as TDV, gates as tdv
from quantum_computations_tpu_torch.gkp import MB2Type, MBGKPCircuit as TCircuit
from quantum_computations_tpu_torch.pipelines import grover as tgrover

from test_torch_batched_gkp import _record_jax as _record_batched, \
    _replay_in_port as _replay_batched

RUN_TOL = 1e-8
QS = np.linspace(-20, 20, 160)
EPS = float(db2eps(10.0))
BATCH = 2
GATES = ("H", "P", "Pdg", "T", "Tdg", "CZ", "SWAP", "I", "X", "Z")


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


def _gates(module, names):
    return [eval(n, {k: getattr(module, k) for k in GATES}) for n in names]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


def _contract(tensors):
    out = tensors[0]
    for t in tensors[1:]:
        out = np.tensordot(out, t, axes=(out.ndim - 1, 0))
    return out


# ---------------------------------------------------------------------------
# device frame and syndrome arithmetic
# ---------------------------------------------------------------------------

def test_commute_frame_matches_jax_for_every_gate_and_frame():
    frames = np.array([[[a, b], [c, d]] for a in (0, 1) for b in (0, 1)
                       for c in (0, 1) for d in (0, 1)], np.int32)
    names = ["I(0)", "H(0)", "H(1)", "P(0)", "Pdg(1)", "T(0)", "Tdg(1)",
             "CZ(0, 1)", "CZ(1, 0)", "SWAP(0, 1)"]
    for tg, jg in zip(_gates(tdv, names), _gates(jdv, names)):
        got = tcompiled.CompiledGKP._commute_frame(tg, torch.from_numpy(frames))
        want = np.stack([np.asarray(jcompiled.CompiledGKP._commute_frame(jg, jnp.asarray(f)))
                         for f in frames])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=repr(tg))


def test_device_syndromes_equal_the_host_helpers_and_jax():
    rng = np.random.default_rng(4)
    B = 256
    ma, mb = rng.normal(scale=4.0, size=(2, B))
    sgn = rng.choice([-1.0, 1.0], B)
    arctan2 = float(np.arctan(2))
    cases = [(0.0, np.pi / 2), (np.pi / 4, -np.pi / 4), (0.0, arctan2), (0.0, -arctan2),
             (0.0, sgn * np.pi / 2), (0.0, np.where(sgn > 0, arctan2, np.pi / 2))]
    tm = (torch.from_numpy(ma), torch.from_numpy(mb))
    for ta, tb in cases:
        targs = [torch.from_numpy(x) if np.ndim(x) else x for x in (ta, tb)]
        got = tcompiled._syndrome_from_device(*targs, *tm)
        assert got.dtype == torch.int32 and got.shape == (B, 2)
        np.testing.assert_array_equal(got.numpy(), tcompiled._syndrome_from(ta, tb, ma, mb))
        want = np.asarray(jcompiled._syndrome_from(jnp.asarray(ta), jnp.asarray(tb),
                                                   jnp.asarray(ma), jnp.asarray(mb)))
        np.testing.assert_array_equal(got.numpy(), want.T)
    ms = rng.normal(scale=4.0, size=(4, B))
    for kind in (MB2Type.CZ, MB2Type.SWAP):
        got = tcompiled._two_mode_syndromes_device(kind, [torch.from_numpy(m) for m in ms])
        assert got.dtype == torch.int32 and got.shape == (B, 2, 2)
        np.testing.assert_array_equal(got.numpy(), tcompiled._two_mode_syndromes(kind, ms))


def test_controlled_angle_and_t_sign_follow_the_host_rule_under_forced_syndromes(monkeypatch):
    """[T(0), X(0), T(0)] with every gadget's syndrome forced (a pattern per
    gadget over a batch of 4), so that the frame and the previous layer's
    syndromes take both values: the compiled engine's device angles, T
    signs and Bell coefficients equal the batched engine's host rule
    (float32 angles and phases there; held against JAX in
    ``test_torch_batched_gkp.py``), and both branches of each occur."""
    patterns = [np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32),
                np.array([[1, 1], [1, 0], [0, 0], [0, 1]], np.int32)]
    qs = np.linspace(-10, 10, 64)
    c = TCircuit.transpile(_gates(tdv, ["T(0)", "X(0)", "T(0)"]), 1)
    c.fill()
    opts = dict(max_bond_dim=4, rel_err=1e-2, svd_method="full")
    coeffs = tcompiled.logical_coeffs([TDV.PLUS])

    def force(name, as_tensor):
        seen = []

        def forced(*args):
            out = patterns[len(seen) % 2]
            seen.append(1)
            return torch.from_numpy(out) if as_tensor else out
        monkeypatch.setattr(tcompiled, name, forced)

    def record(obj, name):
        calls, real = [], getattr(obj, name)

        def call(*args, **kw):
            calls.append(args)
            return real(*args, **kw)
        monkeypatch.setattr(obj, name, call)
        return calls

    coeff_of, real_bell = {}, tcompiled.bell_vectors

    def bell(basis, coeff1, dtype):
        out = real_bell(basis, coeff1, dtype)
        coeff_of[id(out)] = torch.as_tensor(coeff1).numpy()
        return out

    monkeypatch.setattr(tcompiled, "bell_vectors", bell)
    force("_syndrome_from_device", True)
    ccalls = record(tcompiled, "_single_gadget")
    cframes, _, _ = tcompiled.CompiledGKP(c, qs, EPS, opts, device="cpu").batched_readout(
        coeffs, 4, rng_seed=1)
    force("_syndrome_from", False)
    hcalls = record(tbatched.BatchedGKP, "_single")
    runner = tbatched.BatchedGKP(qs, EPS, opts, granularity="gadget", fused_single=False,
                                 fused_pair=False, device="cpu")
    _, hframes = runner.run_circuit(c, coeffs, 4, rng_seed=1)

    np.testing.assert_array_equal(cframes.numpy(), hframes)
    assert len(ccalls) == len(hcalls) == 4
    angles, signs = set(), set()
    for cargs, hargs in zip(ccalls, hcalls):
        (meas, syn, bell_t), (meas_a2, _, syn_a2, phase) = cargs[2:5], hargs[3:7]
        a2 = np.broadcast_to(np.asarray(meas[1], np.float64), (4,))
        np.testing.assert_array_equal(a2.astype(np.float32), meas_a2)
        np.testing.assert_array_equal(
            np.broadcast_to(np.asarray(syn[1], np.float64), (4,)).astype(np.float32), syn_a2)
        coeff = coeff_of[id(bell_t)]
        np.testing.assert_allclose(np.angle(coeff), phase, rtol=0, atol=1e-7)
        angles.update(np.round(a2, 12).tolist())
        signs.update(np.sign(np.angle(coeff)).tolist())
    assert {round(np.arctan(2), 12), round(np.pi / 2, 12)} <= angles
    assert {-1.0, 1.0} <= signs


# ---------------------------------------------------------------------------
# whole runs: JAX jit(vmap) recorded, replayed in the port
# ---------------------------------------------------------------------------

def _record_jax(mp):
    """Wrap the JAX program's homodyne, range finder and single gadget to
    record, per trajectory tag, outcomes, sketches and gadget parameters."""
    rec, tag, seq = {}, {}, [0]
    real = {"h": jcompiled._homodyne, "rrf": jlinalg.randomized_range_finder,
            "single": jcompiled._single_gadget}

    def note(kind, *values):
        seq[0] += 1
        jax.debug.callback(
            lambda t, *v, n=seq[0]: rec.setdefault((kind, int(t)), []).append(
                (n, [np.array(x) for x in v])), tag["t"], *values)

    def homodyne(mps, idx, angle, key, *, static_zero=False):
        out = real["h"](mps, idx, angle, key, static_zero=static_zero)
        note("outcome", out)
        return out

    def rrf(A, l, q, key):
        note("sketch", jax.random.normal(key, (A.shape[1], l), dtype=A.real.dtype))
        return real["rrf"](A, l, q, key)

    def single(mps, idx, meas_angles, syn_angles, bell_coeff, *args, **kw):
        note("single", *(jnp.asarray(x, jnp.float64) for x in (meas_angles[1], *syn_angles)),
             jnp.asarray(bell_coeff, jnp.complex128))
        return real["single"](mps, idx, meas_angles, syn_angles, bell_coeff, *args, **kw)

    mp.setattr(jcompiled, "_homodyne", homodyne)
    mp.setattr(jlinalg, "randomized_range_finder", rrf)
    mp.setattr(jcompiled, "_single_gadget", single)

    def tagged(fn):
        def run(t, *args):
            tag["t"] = t
            return fn(*args)
        return run

    def records():
        jax.effects_barrier()
        return {k: [v for _, v in sorted(x, key=lambda p: p[0])] for k, x in rec.items()}

    return tagged, records


def _replay_in_port(mp, rec):
    """Force the recorded outcomes (as grid indices) and sketches in the
    port, in the order it asks for them (one draw per homodyne for the
    batch; one sketch per matrix of a batched split, in trajectory order),
    and record the port's single-gadget parameters."""
    outcomes = [[int(np.argmin(np.abs(QS - v[0]))) for v in rec[("outcome", b)]]
                for b in range(BATCH)]
    sketches = [[v[0] for v in rec.get(("sketch", b), [])] for b in range(BATCH)]
    count = {"outcome": 0, "sketch": 0}
    singles, bells = [], {}
    real_single, real_bell = tcompiled._single_gadget, tcompiled.bell_vectors

    def draw(dist, forced, generator):
        k = count["outcome"]
        count["outcome"] += 1
        return torch.tensor([outcomes[b][k] for b in range(BATCH)])

    def sketch(n, l, generator, like):
        c = count["sketch"]
        count["sketch"] += 1
        o = sketches[c % BATCH][c // BATCH]
        assert o.shape == (n, l), (o.shape, n, l)
        return torch.from_numpy(o).to(like.dtype)

    def bell(basis, coeff1, dtype):
        out = real_bell(basis, coeff1, dtype)
        bells[id(out)] = torch.as_tensor(coeff1).numpy()
        return out

    def single(tensors, idx, meas_angles, syn_angles, bell_t, *args, **kw):
        singles.append([np.broadcast_to(np.asarray(x, np.float64), (BATCH,))
                        for x in (meas_angles[1], *syn_angles)] + [bells[id(bell_t)]])
        return real_single(tensors, idx, meas_angles, syn_angles, bell_t, *args, **kw)

    mp.setattr(tcompiled, "_draw", draw)
    mp.setattr(tlinalg, "_gaussian_sketch", sketch)
    mp.setattr(tcompiled, "bell_vectors", bell)
    mp.setattr(tcompiled, "_single_gadget", single)
    left = lambda: {"outcome": sum(map(len, outcomes)) - BATCH * count["outcome"],  # noqa: E731
                    "sketch": sum(map(len, sketches)) - count["sketch"]}
    return singles, left


RUNS = {
    # name: (gates, modes, svd_method, cap, readout)
    "IHP": (["I(0)", "H(0)", "P(0)"], 1, "full", 8, False),
    "CZ_SWAP": (["CZ(0, 1)", "SWAP(0, 1)"], 2, "full", 8, False),
    "test_circuit": (None, 2, "full", 8, True),
    "test_circuit_randomized": (None, 2, "auto", 16, True),
}


def _compiled_parity_run(name):
    names, n, method, cap, readout = RUNS[name]
    opts = dict(max_bond_dim=cap, rel_err=1e-2, svd_method=method)
    if names is None:
        tgates, tinit = tgrover.test_circuit()
        jgates, jinit = jgrover.test_circuit()
    else:
        tgates, jgates = _gates(tdv, names), _gates(jdv, names)
        tinit = jinit = None
    keys = jax.random.split(jax.random.PRNGKey(5), BATCH)
    with pytest.MonkeyPatch.context() as mp:
        tagged, records = _record_jax(mp)
        jc = JCircuit.transpile(jgates, n)
        jc.fill()
        jprog = jcompiled.CompiledGKP(jc, QS, EPS, JOpts(**opts))
        if readout:
            coeffs = jcompiled.logical_coeffs(jinit)
            fn = tagged(lambda k: jprog.trajectory_with_readout(coeffs, k))
            jframes, jre, jim = jax.jit(jax.vmap(fn))(jnp.arange(BATCH), keys)
            jout = np.asarray(jre) + 1j * np.asarray(jim)
        else:
            init = jparse([JDV.ZERO] * n, EPS, QS).tensors
            fn = tagged(lambda k, ts: jprog.trajectory(ts, k))
            jt, jframes = jax.jit(jax.vmap(fn))(jnp.arange(BATCH), keys,
                                                [jnp.stack([t] * BATCH) for t in init])
            jout = [np.asarray(t) for t in jt]
        rec = records()
        singles, left = _replay_in_port(mp, rec)
        tc = TCircuit.transpile(tgates, n)
        tc.fill()
        tprog = tcompiled.CompiledGKP(tc, QS, EPS, opts, device="cpu")
        if readout:
            tframes, tre, tim = tprog.batched_readout(tcompiled.logical_coeffs(tinit), BATCH,
                                                      rng_seed=0)
            tout = (tre + 1j * tim).numpy()
        else:
            init = [torch.from_numpy(np.array(t))[None].repeat(BATCH, 1, 1, 1)
                    for t in jparse([JDV.ZERO] * n, EPS, QS).tensors]
            tt, tframes = tprog.trajectory(init, rng_seed=0)
            tout = [t.numpy() for t in tt]
    jsingles = [[np.stack([rec[("single", b)][k][j] for b in range(BATCH)]) for j in range(4)]
                for k in range(len(rec.get(("single", 0), [])))]
    return {"jax": (np.asarray(jframes), jout, jsingles), "port": (tframes, tout, singles),
            "left": left(), "recorded": {k[0]: len(v) for k, v in rec.items() if k[1] == 0}}


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    return request.param, _compiled_parity_run(request.param)


def test_compiled_run_replays_every_draw_and_sketch(run):
    name, r = run
    assert r["left"] == {"outcome": 0, "sketch": 0}
    assert r["recorded"]["outcome"] > 0
    assert (r["recorded"].get("sketch", 0) > 0) == name.endswith("randomized")


def test_compiled_run_frames_match_jax_exactly(run):
    _, r = run
    tframes = r["port"][0]
    assert tframes.dtype == torch.int32 and tframes.shape == (BATCH, RUNS[run[0]][1], 2)
    np.testing.assert_array_equal(tframes.numpy(), r["jax"][0])


def test_compiled_run_state_matches_jax(run):
    """Readout runs: the syndrome-corrected raw logical densities; the
    others: the static-cap shapes and the contracted final states."""
    name, r = run
    (_, jout, _), (_, tout, _) = r["jax"], r["port"]
    if RUNS[name][4]:
        assert tout.shape == (BATCH, 4, 4)
        for a, b in zip(tout, jout):
            _close(a, b, RUN_TOL)
        return
    assert [t.shape for t in tout] == [t.shape for t in jout]
    for b in range(BATCH):
        _close(_contract([t[b] for t in tout]), _contract([t[b] for t in jout]), RUN_TOL)


def test_compiled_run_gadget_parameters_match_jax(run):
    """Every single-mode gadget's second measured angle, syndrome angles
    and Bell coefficient: the controlled P's device angle and the T
    gadget's frame sign among them (test circuit: T on both modes, then
    their controlled P)."""
    name, r = run
    jsingles, tsingles = r["jax"][2], r["port"][2]
    assert len(tsingles) == len(jsingles)
    for t, j in zip(tsingles, jsingles):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the production engine on the Grover test circuit
# ---------------------------------------------------------------------------

def test_batched_engine_on_the_grover_test_circuit_matches_jax():
    """``BatchedGKP`` with its production settings on
    ``grover.test_circuit()`` (T on both modes, their classically
    controlled P, a CZ macronode, H gadgets), from |H>|H>, against the JAX
    engine with its draws and sketches replayed as in
    ``test_torch_batched_gkp.py``: frames and syndromes exactly, rho at
    1e-8."""
    opts = {"max_bond_dim": 8, "rel_err": 1e-2}
    tgates, tinit = tgrover.test_circuit()
    jgates, jinit = jgrover.test_circuit()
    with pytest.MonkeyPatch.context() as mp:
        rec = _record_batched(mp)
        jc = JCircuit.transpile(jgates, 2)
        jc.fill()
        jrunner = jbatched.BatchedGKP(QS, EPS, JOpts(**opts), adaptive=True,
                                      granularity="op")
        jt, jframes = jrunner.run_circuit(jc, jcompiled.logical_coeffs(jinit), BATCH,
                                          rng_seed=11)
        jre, jim = jrunner.readout(jt, jframes)
        jsynd = list(rec["synd"])
        tsynd = _replay_batched(mp, rec)
        tc = TCircuit.transpile(tgates, 2)
        tc.fill()
        runner = tbatched.BatchedGKP(QS, EPS, opts, adaptive=True, granularity="op",
                                     device="cpu")
        tt, tframes = runner.run_circuit(tc, tcompiled.logical_coeffs(tinit), BATCH,
                                         rng_seed=11)
        re, im = runner.readout(tt, tframes)
    assert {k: len(v) for k, v in rec.items() if k != "synd"} == \
        {"single": 0, "pair": 0, "rsvd": 0, "stream": 0}
    assert runner.counts["fused_single"] == 8 and runner.counts["bs"] == 2
    np.testing.assert_array_equal(tframes, jframes)
    assert len(tsynd) == len(jsynd) == 9
    for a, b in zip(tsynd, jsynd):
        np.testing.assert_array_equal(a, b)
    assert [tuple(t.shape) for t in tt] == [t.shape for t in jt]
    for a, b in zip((re + 1j * im).numpy(), np.asarray(jre) + 1j * np.asarray(jim)):
        _close(a, b, RUN_TOL)


# ---------------------------------------------------------------------------
# entry points alone
# ---------------------------------------------------------------------------

def test_readout_entry_points_and_batched_match_trajectory():
    """``trajectory_with_readout`` gives one trajectory's unbatched real and
    integer tensors; ``batched_readout`` (float32 coefficients) and
    ``batched`` (an MPS broadcast over the batch) draw alike from one
    seed, and the raw traces stay in (0.9, 1]."""
    from quantum_computations_tpu_torch.cv import MPS
    from quantum_computations_tpu_torch.gkp import full_logical_density_mps
    from quantum_computations_tpu_torch.gkp.utils import logical_density_batch
    qs = np.linspace(-10, 10, 64)
    c = TCircuit.transpile(_gates(tdv, ["H(0)", "P(0)"]), 1)
    c.fill()
    prog = tcompiled.CompiledGKP(c, qs, EPS, dict(max_bond_dim=4, rel_err=1e-2),
                                 device="cpu")
    coeffs = tcompiled.logical_coeffs([TDV.ZERO])
    f1, re1, im1 = prog.trajectory_with_readout(coeffs, rng_seed=3)
    assert f1.shape == (1, 2) and re1.shape == im1.shape == (2, 2)
    assert not re1.is_complex() and f1.dtype == torch.int32
    fb, reb, imb = prog.batched_readout(coeffs, 3, rng_seed=3)
    assert fb.shape == (3, 1, 2) and reb.shape == (3, 2, 2)
    assert all(0.9 < float(torch.trace(r)) <= 1 + 1e-9 for r in reb)
    init = MPS(qs, [torch.from_numpy(np.array(t)) for t in
                    jparse([JDV.ZERO], EPS, qs).tensors])
    tensors, frames = prog.batched(init, 3, rng_seed=3)
    assert [tuple(t.shape[:1]) for t in tensors] == [(3,)]
    np.testing.assert_array_equal(frames.numpy(), fb.numpy())
    again, frames_again = prog.batched(init, 3, rng_seed=3)  # one seed, one result
    np.testing.assert_array_equal(frames_again.numpy(), frames.numpy())
    np.testing.assert_array_equal(again[0].numpy(), tensors[0].numpy())
    rho = logical_density_batch(tensors, qs)[0].numpy()
    _close(rho, full_logical_density_mps(MPS(qs, [t[0] for t in tensors])).numpy(), 1e-12)


@pytest.mark.parametrize("names,init,want", [
    (["H(0)"], "ZERO", None), (["P(0)"], "ZERO", None), (["T(0)"], "ZERO", None),
    (["H(0)", "T(0)", "H(0)"], "ZERO", None), (["T(0)", "T(0)"], "H", ["P(0)"])],
    ids=["H", "P", "T", "HTH", "TT"])
def test_compiled_single_qubit_circuits_reach_the_dv_state(names, init, want):
    """The JAX package's single-qubit compiled tests
    (``test_gkp_compiled.py``; T, HTH and the T correction are marked slow
    there): six trajectories in one batch at d = 300, cap 8, 10 dB, the
    mean fidelity of the normalised corrected rho to the DV state above
    0.8 (T T = P from |H>, which runs the classically controlled P: 0.75)."""
    from quantum_computations_tpu_torch.dv import Simulator as DVSim, qop
    qs = np.linspace(-20, 20, 300)
    c = TCircuit.transpile(_gates(tdv, names), 1)
    c.fill()
    prog = tcompiled.CompiledGKP(c, qs, EPS, dict(max_bond_dim=8, rel_err=1e-2), device="cpu")
    _, re, im = prog.batched_readout(tcompiled.logical_coeffs([TDV[init]]), 6, rng_seed=0)
    state = DVSim(_gates(tdv, want or names), device="cpu").run([TDV[init]])
    fids = [float(qop.fidelity(state, r / torch.trace(r))) for r in re + 1j * im]
    assert np.mean(fids) > (0.75 if want else 0.8), fids
