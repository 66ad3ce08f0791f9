"""The port's explicit-collective sharded state vector
(``parallel/shardmap_sv.ShardMapStateVector``) against the JAX engine, case
for case with ``tests/test_shardmap_sv.py``, on the CPU at complex128.

The port runs on gloo worlds of D = 2, 4 and 8 ranks (one world per D for
the whole file, in a module-scoped fixture that runs every case and
returns rank 0's results); the JAX engine runs on
``data_mesh(jax.devices()[:D])`` of the 8-device virtual CPU mesh, on the
same numpy-seeded gates. States, layout tables and slab plans are held
against JAX's at 1e-10 (plans exactly), and against a dense numpy
reference as the JAX tests hold them. Sampling and sampled measurement
draw from torch generators, so their outcomes cannot equal JAX's: the
two-stage distribution (the ranks' masses and local probabilities) is
held against JAX's state, the samples to the JAX tests' statistical
bounds, and the collapsed states against JAX's engine post-selected on the
port's outcomes. Ranks import this module to find their functions, so
JAX is imported inside the reference helpers only.
"""

import numpy as np
import pytest

from quantum_computations_tpu_torch.dv import qop
from quantum_computations_tpu_torch.parallel import launch
from quantum_computations_tpu_torch.parallel.shardmap_sv import ShardMapStateVector

TOL = 1e-10
WORLDS = (2, 4, 8)


def rand_u(rng, d):
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, _ = np.linalg.qr(a)
    return q


def dense_run(N, circuit):
    """Dense numpy reference: big-endian qubits, tensordot per gate."""
    psi = np.zeros((2,) * N, complex)
    psi.flat[0] = 1.0
    for m, t in circuit:
        k = len(t)
        op = np.asarray(m, complex).reshape((2,) * (2 * k))
        psi = np.tensordot(op, psi, axes=(list(range(k, 2 * k)), list(t)))
        psi = np.moveaxis(psi, list(range(k)), list(t))
    return psi.reshape(-1)


def marginals(psi, N):
    t = np.abs(psi.reshape((2,) * N)) ** 2
    return np.array([t.sum(axis=tuple(i for i in range(N) if i != q))
                     for q in range(N)])


# ---------------------------------------------------------------------------
# circuits (numpy, seeded: the same gates reach both engines)
# ---------------------------------------------------------------------------

def c_local():
    rng = np.random.default_rng(11)
    return 8, [(qop.H, (4,)), (rand_u(rng, 2), (7,)), (rand_u(rng, 4), (3, 6))]


def c_lazy():
    rng = np.random.default_rng(12)
    return 8, [(qop.H, (0,)), (rand_u(rng, 2), (1,)), (qop.H, (0,))]


def c_mixed():
    rng = np.random.default_rng(13)
    return 9, [(qop.H, (0,)), (rand_u(rng, 4), (0, 8)), (qop.CZ, (1, 2)),
               (rand_u(rng, 2), (5,)), (rand_u(rng, 4), (2, 0)), (qop.CX, (7, 3)),
               (rand_u(rng, 4), (1, 6)), (qop.H, (2,))]


def c_ghz():
    return 8, [(qop.H, (0,))] + [(qop.CX, (0, t)) for t in range(1, 8)]


def c_collapse():
    rng = np.random.default_rng(14)
    return 8, [(qop.H, (2,)), (rand_u(rng, 2), (5,))]


def c_chain_ghz():
    return 8, [(qop.H, (0,))] + [(qop.CX, (i, i + 1)) for i in range(7)]


def c_product():
    rng = np.random.default_rng(15)
    return 8, [(rand_u(rng, 2), (q,)) for q in range(8)] + [(qop.CX, (0, 5))]


def c_windows():
    rng = np.random.default_rng(16)
    circuit = [(rand_u(rng, 2), (q,)) for q in [9, 4, 0, 6, 2, 8, 5]]
    return 10, circuit + [(rand_u(rng, 4), (1, 7)), (rand_u(rng, 2), (3,)),
                          (rand_u(rng, 4), (9, 2))]


def c_unsorted():
    return 8, [(rand_u(np.random.default_rng(17), 8), (7, 3, 5))]


def c_small_slab():
    rng = np.random.default_rng(18)
    return 9, [(rand_u(rng, 4), (3, 8)), (rand_u(rng, 4), (4, 6)), (rand_u(rng, 2), (5,)),
               (rand_u(rng, 4), (3, 4)), (rand_u(rng, 4), (7, 8)), (rand_u(rng, 2), (0,))]


def c_minor_safe():
    rng = np.random.default_rng(19)
    return 10, [(rand_u(rng, 4), (3, 9)), (rand_u(rng, 4), (4, 5)),
                (rand_u(rng, 4), (8, 9)), (rand_u(rng, 4), (3, 4))]


def c_slab_readout():
    rng = np.random.default_rng(20)
    return 9, [(qop.H, (0,)), (rand_u(rng, 4), (0, 5)), (rand_u(rng, 2), (8,)),
               (rand_u(rng, 4), (7, 8))]


def c_planner():
    rng = np.random.default_rng(21)
    circuit = []
    for _ in range(3):  # A B A B A B: A on rank-bit qubits, B local
        circuit.append((rand_u(rng, 4), (0, 1)))
        circuit.append((rand_u(rng, 4), (8, 9)))
    return 10, circuit


def c_rerun():
    rng = np.random.default_rng(22)
    return 8, [(rand_u(rng, 2), (0,)), (rand_u(rng, 4), (1, 7)), (rand_u(rng, 2), (5,))]


def c_load_first():
    rng = np.random.default_rng(23)
    return 9, [(qop.H, (0,)), (rand_u(rng, 4), (1, 8)), (rand_u(rng, 2), (2,))]


def c_load_rest():
    rng = np.random.default_rng(24)
    return 9, [(rand_u(rng, 4), (0, 2)), (rand_u(rng, 2), (1,)), (qop.CZ, (3, 6))]


TELEPORT_U = rand_u(np.random.default_rng(25), 2)
STAT_TRIALS = 40


def oversize(n):
    """A gate on qubits 0..n-1: one qubit wider than the local bits (a
    window) or than the slab min(7, L) (a slab gate); the JAX tests' 6 is
    one wider than their 5 local bits (D = 8)."""
    return rand_u(np.random.default_rng(26), 2 ** n), tuple(range(n))


# ---------------------------------------------------------------------------
# the port: every case, run on every rank of one world
# ---------------------------------------------------------------------------

def _gen(seed):
    import torch
    return torch.Generator().manual_seed(seed)


def _apply_all(sv, circuit):
    for m, t in circuit:
        sv.apply(m, t)
    return sv


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _port_cases(mesh, jax_state):
    """Every case on this rank; rank 0's dict is what the fixture gets."""
    out = {}
    new = lambda N: ShardMapStateVector(N, mesh)  # noqa: E731

    for name, build in (("local", c_local), ("lazy", c_lazy), ("mixed", c_mixed),
                        ("ghz", c_ghz)):
        N, circuit = build()
        sv = _apply_all(new(N), circuit)
        out[name] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of), k=sv.k,
                         norm=float(sv.norm()))

    sv = new(8)
    sv.apply(qop.H, (0,))
    sv.apply(qop.H, (5,))
    probs = {q: sv.probabilities(q).numpy() for q in (0, 5, 3)}
    out["any_layout"] = dict(probs=probs, fresh=new(8).probabilities(1).numpy(),
                             slot_of=list(sv.slot_of))

    N, circuit = c_collapse()
    out["collapse"] = {}
    for outcome in (0, 1):
        sv = _apply_all(new(N), circuit)
        got = sv.measure(2, result=outcome)
        out["collapse"][outcome] = dict(got=got, dense=sv.to_dense(),
                                        norm=float(sv.norm()))

    sv = new(8)
    sv.apply(qop.H, (3,))
    q = 1 if sv.k >= 2 else 0  # the JAX test's qubit 1 is a rank bit at k = 3
    stayed = sv.slot_of[q] < sv.k
    got = sv.measure(q, result=0)
    out["global_measure"] = dict(q=q, stayed=stayed, got=got, norm=float(sv.norm()),
                                 dense=sv.to_dense())

    sv = new(8)
    got = sv.measure(4, result=0, theta=np.pi / 2)
    out["x_axis"] = dict(got=got, dense=sv.to_dense())

    counts = [0, 0]
    for s in range(STAT_TRIALS):
        sv = new(8)
        sv.apply(qop.H, (6,))
        if s == 0:
            p = sv.probabilities(6).numpy()
        counts[sv.measure(6, _gen(s))] += 1
    out["stats"] = dict(counts=counts, probs=p)

    out["teleport"] = []
    for seed in range(4):
        sv = new(8)
        sv.apply(TELEPORT_U, (0,))
        sv.apply(qop.CX, (0, 1))
        sv.apply(qop.H, (0,))
        m = sv.measure(0, _gen(seed))
        if m == 1:
            sv.apply(np.diag([1.0, -1.0]), (1,))
        out["teleport"].append(dict(m=m, dense=sv.to_dense()))

    for name, build, shots, seed in (("ghz_samples", c_chain_ghz, 200, 0),
                                     ("dense_samples", c_product, 600, 1)):
        N, circuit = build()
        sv = _apply_all(new(N), circuit)
        masses, local = sv.sampling_distribution()
        out[name] = dict(bits=sv.sample(_gen(seed), shots), masses=masses,
                         local=mesh.all_gather(local[None]).numpy(),
                         slot_of=list(sv.slot_of))

    N, circuit = c_windows()
    sv = new(N).run_fused(circuit)
    out["fused_windows"] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of))

    N, [(u, t)] = c_unsorted()
    sv = new(N).apply_window(u, t)
    out["unsorted"] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of))

    sv = new(8)
    u, t = oversize(sv.L + 1)
    out["window_cap"] = dict(raised=_raises(lambda: sv.apply_window(u, t)))

    for name, build, kw, attrs in (
            ("slab", c_windows, {}, {}),
            ("small_slab", c_small_slab, dict(max_bits=2), {}),
            ("minor_safe", c_minor_safe, dict(max_bits=2), dict(SCATTER_MOVE_MAX=0))):
        N, circuit = build()
        sv = new(N)
        for a, v in attrs.items():
            setattr(sv, a, v)
        sv.run_fused_slab(circuit, **kw)
        out[name] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of),
                         plan=sv.last_plan)

    N, circuit = c_slab_readout()
    sv = new(N).run_fused_slab(circuit)
    probs = {q: sv.probabilities(q).numpy() for q in (0, 5, 8)}
    slot_before = list(sv.slot_of)
    got = sv.measure(5, result=0)
    out["slab_readout"] = dict(probs=probs, slot_of=slot_before, plan=sv.last_plan,
                               got=got, dense=sv.to_dense(),
                               bits=sv.sample(_gen(3), 200))

    sv = new(8)
    u, t = oversize(min(7, sv.L) + 1)
    out["oversize"] = dict(raised=_raises(lambda: sv.run_fused_slab([(u, t)])))

    N, circuit = c_planner()
    out["planner"] = {}
    for planned in (False, True):
        sv = new(N).run_fused_slab(circuit, max_bits=2, plan_windows=planned)
        out["planner"][planned] = dict(dense=sv.to_dense(), plan=sv.last_plan,
                                       slot_of=list(sv.slot_of))

    N, circuit = c_rerun()
    sv = new(N)
    out["rerun"] = []
    for _ in range(3):
        sv.run_fused_slab(circuit)
        out["rerun"].append(dict(dense=sv.to_dense(), slot_of=list(sv.slot_of),
                                 plan=sv.last_plan))

    N, rest = c_load_rest()
    blocks, slot_of = jax_state
    sv = new(N).load_numpy(blocks, slot_of)
    loaded = sv.to_dense()
    _apply_all(sv, rest)
    out["load"] = dict(loaded=loaded, dense=sv.to_dense(), slot_of=list(sv.slot_of))
    return out


# ---------------------------------------------------------------------------
# the JAX engine on the same gates
# ---------------------------------------------------------------------------

def _jax_plan(jsv):
    return list(jsv._fused_cache)[-1][0]


def _jax_cases(D, port):
    """The JAX engine on D virtual devices; outcomes the port sampled are
    post-selected (``port`` holds them)."""
    import jax
    from quantum_computations_tpu.dv import qop as jqop
    from quantum_computations_tpu.parallel import data_mesh
    from quantum_computations_tpu.parallel.shardmap_sv import ShardMapStateVector as JSV

    mesh = data_mesh(jax.devices()[:D])
    new = lambda N: JSV(N, mesh)  # noqa: E731
    out = {}
    for name, build in (("local", c_local), ("lazy", c_lazy), ("mixed", c_mixed),
                        ("ghz", c_ghz)):
        N, circuit = build()
        sv = _apply_all(new(N), circuit)
        out[name] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of))

    sv = new(8)
    sv.apply(jqop.H, (0,))
    sv.apply(jqop.H, (5,))
    out["any_layout"] = dict(probs={q: np.asarray(sv.probabilities(q)) for q in (0, 5, 3)},
                             fresh=np.asarray(new(8).probabilities(1)),
                             slot_of=list(sv.slot_of))

    N, circuit = c_collapse()
    out["collapse"] = {}
    for outcome in (0, 1):
        sv = _apply_all(new(N), circuit)
        sv.measure(2, result=outcome)
        out["collapse"][outcome] = dict(dense=sv.to_dense())

    sv = new(8)
    sv.apply(jqop.H, (3,))
    sv.measure(port["global_measure"]["q"], result=0)
    out["global_measure"] = dict(dense=sv.to_dense())

    sv = new(8)
    sv.measure(4, result=0, theta=np.pi / 2)
    out["x_axis"] = dict(dense=sv.to_dense())

    sv = new(8)
    sv.apply(jqop.H, (6,))
    out["stats"] = dict(probs=np.asarray(sv.probabilities(6)))

    out["teleport"] = []
    for rec in port["teleport"]:
        sv = new(8)
        sv.apply(TELEPORT_U, (0,))
        sv.apply(jqop.CX, (0, 1))
        sv.apply(jqop.H, (0,))
        sv.measure(0, result=rec["m"])
        if rec["m"] == 1:
            sv.apply(np.diag([1.0, -1.0]), (1,))
        out["teleport"].append(dict(dense=sv.to_dense()))

    for name, build in (("ghz_samples", c_chain_ghz), ("dense_samples", c_product)):
        N, circuit = build()
        sv = _apply_all(new(N), circuit)
        p = np.abs(np.asarray(sv.state)) ** 2
        masses = p.sum(1)
        out[name] = dict(masses=masses, local=p / np.where(masses > 0, masses, 1)[:, None],
                         slot_of=list(sv.slot_of))

    N, circuit = c_windows()
    sv = new(N).run_fused(circuit)
    out["fused_windows"] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of))

    N, [(u, t)] = c_unsorted()
    sv = new(N).apply_window(u, t)
    out["unsorted"] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of))

    sv = new(8)
    u, t = oversize(sv.L + 1)
    out["window_cap"] = dict(raised=_raises(lambda: sv.apply_window(u, t)))

    for name, build, kw, attrs in (
            ("slab", c_windows, {}, {}),
            ("small_slab", c_small_slab, dict(max_bits=2), {}),
            ("minor_safe", c_minor_safe, dict(max_bits=2), dict(SCATTER_MOVE_MAX=0))):
        N, circuit = build()
        sv = new(N)
        for a, v in attrs.items():
            setattr(sv, a, v)
        sv.run_fused_slab(circuit, **kw)
        out[name] = dict(dense=sv.to_dense(), slot_of=list(sv.slot_of), plan=_jax_plan(sv))

    N, circuit = c_slab_readout()
    sv = new(N).run_fused_slab(circuit)
    out["slab_readout"] = dict(probs={q: np.asarray(sv.probabilities(q)) for q in (0, 5, 8)},
                               slot_of=list(sv.slot_of), plan=_jax_plan(sv))
    sv.measure(5, result=0)
    out["slab_readout"]["dense"] = sv.to_dense()

    sv = new(8)
    u, t = oversize(min(7, sv.L) + 1)
    out["oversize"] = dict(raised=_raises(lambda: sv.run_fused_slab([(u, t)])))

    N, circuit = c_planner()
    out["planner"] = {}
    for planned in (False, True):
        sv = new(N)
        sv.run_fused_slab(circuit, max_bits=2, plan_windows=planned)
        out["planner"][planned] = dict(dense=sv.to_dense(), plan=_jax_plan(sv),
                                       slot_of=list(sv.slot_of))

    N, circuit = c_rerun()
    sv = new(N)
    out["rerun"] = []
    for _ in range(3):
        sv.run_fused_slab(circuit)
        out["rerun"].append(dict(dense=sv.to_dense(), slot_of=list(sv.slot_of),
                                 plan=_jax_plan(sv)))

    N, rest = c_load_rest()
    sv = _apply_all(new(N), c_load_first()[1])
    state = (np.asarray(sv.state), list(sv.slot_of))
    out["load"] = dict(loaded=sv.to_dense())
    _apply_all(sv, rest)
    out["load"].update(dense=sv.to_dense(), slot_of=list(sv.slot_of))
    return out, state


def _jax_mid_state(D):
    """JAX's (D, 2^L) state and layout after c_load_first (the port loads it)."""
    import jax
    from quantum_computations_tpu.parallel import data_mesh
    from quantum_computations_tpu.parallel.shardmap_sv import ShardMapStateVector as JSV

    N, first = c_load_first()
    sv = _apply_all(JSV(N, data_mesh(jax.devices()[:D])), first)
    return np.asarray(sv.state), list(sv.slot_of)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda D: f"D{D}")
def world(request):
    D = request.param
    port = launch(_port_cases, D, _jax_mid_state(D), device="cpu")
    jax_out, _ = _jax_cases(D, port)
    return D, port, jax_out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def _same(port, jax_out, name):
    _close(port[name]["dense"], jax_out[name]["dense"])
    assert port[name]["slot_of"] == jax_out[name]["slot_of"]


# ---------------------------------------------------------------------------
# the JAX tests' cases
# ---------------------------------------------------------------------------

def test_local_gates_no_communication(world):
    _, port, jax_out = world
    N, circuit = c_local()
    _close(port["local"]["dense"], dense_run(N, circuit))
    _same(port, jax_out, "local")
    assert port["local"]["slot_of"] == list(range(N))  # no swaps happened


def test_global_gate_triggers_lazy_swap(world):
    _, port, jax_out = world
    N, circuit = c_lazy()
    _close(port["lazy"]["dense"], dense_run(N, circuit))
    _same(port, jax_out, "lazy")
    k, slot_of = port["lazy"]["k"], port["lazy"]["slot_of"]
    assert slot_of[0] >= k and slot_of[1] >= k  # lazy, not swapped back


def test_mixed_circuit_matches_dense(world):
    _, port, jax_out = world
    N, circuit = c_mixed()
    _close(port["mixed"]["dense"], dense_run(N, circuit))
    _same(port, jax_out, "mixed")
    assert abs(port["mixed"]["norm"] - 1.0) < TOL


def test_probabilities_any_layout(world):
    _, port, jax_out = world
    got, want = port["any_layout"], jax_out["any_layout"]
    for q, p in [(0, [0.5, 0.5]), (5, [0.5, 0.5]), (3, [1.0, 0.0])]:
        _close(got["probs"][q], p)
        _close(got["probs"][q], want["probs"][q])
    _close(got["fresh"], [1.0, 0.0], 1e-12)  # slot 1 of a fresh state
    _close(got["fresh"], want["fresh"])
    assert got["slot_of"] == want["slot_of"]


def test_ghz_across_global_and_local(world):
    _, port, jax_out = world
    N, circuit = c_ghz()
    _close(port["ghz"]["dense"], dense_run(N, circuit))
    _same(port, jax_out, "ghz")


def test_measure_z_collapse_matches_dense(world):
    _, port, jax_out = world
    N, circuit = c_collapse()
    for outcome in (0, 1):
        got = port["collapse"][outcome]
        assert got["got"] == outcome
        t = dense_run(N, circuit).reshape((2,) * N)
        t = np.moveaxis(t, 2, 0)
        t[1 - outcome] = 0.0
        t = np.moveaxis(t, 0, 2).reshape(-1)
        _close(got["dense"], t / np.linalg.norm(t))
        _close(got["dense"], jax_out["collapse"][outcome]["dense"])
        assert abs(got["norm"] - 1.0) < TOL


def test_measure_global_slot_qubit(world):
    _, port, jax_out = world
    got = port["global_measure"]
    assert got["stayed"]  # the qubit is still in a rank bit when measured
    assert got["got"] == 0
    assert abs(got["norm"] - 1.0) < TOL
    _close(got["dense"], jax_out["global_measure"]["dense"])


def test_measure_x_axis(world):
    _, port, jax_out = world
    N = 8
    psi = port["x_axis"]["dense"].reshape((2,) * N)
    amp = np.moveaxis(psi, 4, 0).reshape(2, -1)[:, 0]
    _close(amp, [2 ** -0.5, 2 ** -0.5])
    _close(port["x_axis"]["dense"], jax_out["x_axis"]["dense"])


def test_measure_sampled_statistics(world):
    """Sampled Z outcomes of H|0> are ~Bernoulli(1/2); the distribution
    they are drawn from is JAX's."""
    _, port, jax_out = world
    _close(port["stats"]["probs"], jax_out["stats"]["probs"])
    assert sum(port["stats"]["counts"]) == STAT_TRIALS
    assert 8 <= port["stats"]["counts"][1] <= 32  # p < 1e-4 of failing for a fair coin


def test_feedforward_circuit_teleport(world):
    _, port, jax_out = world
    N = 8
    for got, want in zip(port["teleport"], jax_out["teleport"]):
        psi = got["dense"].reshape((2,) * N)
        amp = np.moveaxis(psi, 1, 0).reshape(2, -1)
        nz = np.abs(amp).sum(axis=0).argmax()
        ket = amp[:, nz]
        target = TELEPORT_U @ np.array([1.0, 0.0])
        ref = np.argmax(np.abs(target))
        phase = ket[ref] / target[ref]
        assert np.isclose(np.abs(phase), 1.0, atol=1e-8)
        _close(ket, target * phase, 1e-8)
        _close(got["dense"], want["dense"])


def _distribution_matches_jax(got, want):
    _close(got["masses"], want["masses"])
    _close(got["local"], want["local"])
    assert got["slot_of"] == want["slot_of"]


def test_sample_bitstrings_distribution(world):
    _, port, jax_out = world
    N = 8
    got = port["ghz_samples"]
    _distribution_matches_jax(got, jax_out["ghz_samples"])
    bits = got["bits"]
    assert bits.shape == (200, N)
    assert {tuple(r) for r in bits.tolist()} <= {tuple([0] * N), tuple([1] * N)}
    assert 0.3 < np.mean(bits[:, 0]) < 0.7


def test_sample_matches_dense_distribution(world):
    _, port, jax_out = world
    N, circuit = c_product()
    got = port["dense_samples"]
    _distribution_matches_jax(got, jax_out["dense_samples"])
    p1s = marginals(dense_run(N, circuit), N)[:, 1]
    for q in range(N):
        p1 = p1s[q]
        se = max(np.sqrt(p1 * (1 - p1) / 600), 1e-3)
        assert abs(got["bits"][:, q].mean() - p1) < 5 * se, (q, p1)


def test_run_fused_windows_match_dense(world):
    _, port, jax_out = world
    N, circuit = c_windows()
    _close(port["fused_windows"]["dense"], dense_run(N, circuit), 1e-8)
    _same(port, jax_out, "fused_windows")


def test_apply_window_unsorted_targets(world):
    _, port, jax_out = world
    N, circuit = c_unsorted()
    _close(port["unsorted"]["dense"], dense_run(N, circuit))
    _same(port, jax_out, "unsorted")


def test_window_cap_respects_local_bits(world):
    _, port, jax_out = world
    assert port["window_cap"]["raised"] and jax_out["window_cap"]["raised"]


def _slab_matches(port, jax_out, name, build):
    N, circuit = build()
    _close(port[name]["dense"], dense_run(N, circuit), 1e-6)
    _same(port, jax_out, name)
    assert port[name]["plan"] == jax_out[name]["plan"]


def test_run_fused_slab_matches_dense(world):
    _, port, jax_out = world
    _slab_matches(port, jax_out, "slab", c_windows)


def test_run_fused_slab_small_slab_forces_moves(world):
    _, port, jax_out = world
    _slab_matches(port, jax_out, "small_slab", c_small_slab)


def test_run_fused_slab_minor_safe_passes(world):
    _, port, jax_out = world
    _slab_matches(port, jax_out, "minor_safe", c_minor_safe)
    assert any(op[0] in ("move", "swap") for op in port["minor_safe"]["plan"])


def test_run_fused_slab_then_measure_and_sample(world):
    _, port, jax_out = world
    N, circuit = c_slab_readout()
    got, want = port["slab_readout"], jax_out["slab_readout"]
    m = marginals(dense_run(N, circuit), N)
    for q in (0, 5, 8):
        _close(got["probs"][q][1], m[q][1], 1e-6)
        _close(got["probs"][q], want["probs"][q])
    assert got["slot_of"] == want["slot_of"] and got["plan"] == want["plan"]
    assert got["got"] == 0
    _close(got["dense"], want["dense"])
    assert got["bits"].shape == (200, N)
    assert (got["bits"][:, 5] == 0).all()  # the collapsed qubit stays collapsed


def test_run_fused_slab_oversize_gate_raises(world):
    _, port, jax_out = world
    assert port["oversize"]["raised"] and jax_out["oversize"]["raised"]


def _a2a(plan):
    return sum(1 for op in plan if op[0] == "a2a")


def test_run_fused_slab_planner_reduces_collectives(world):
    _, port, jax_out = world
    N, circuit = c_planner()
    plain, planned = port["planner"][False], port["planner"][True]
    assert _a2a(planned["plan"]) <= _a2a(plain["plan"])
    want = dense_run(N, circuit)
    _close(plain["dense"], want, 1e-6)
    _close(planned["dense"], want, 1e-6)
    for p in (False, True):
        _close(port["planner"][p]["dense"], jax_out["planner"][p]["dense"])


def test_rerun_same_circuit_matches_jax(world):
    """Counterpart of ``test_fused_cache_lru_bounded``: the port keeps no
    program cache, so re-running one circuit must give JAX's state, layout
    and plan after every run."""
    _, port, jax_out = world
    assert len(port["rerun"]) == 3
    for got, want in zip(port["rerun"], jax_out["rerun"]):
        _close(got["dense"], want["dense"])
        assert got["slot_of"] == want["slot_of"] and got["plan"] == want["plan"]


# ---------------------------------------------------------------------------
# beyond the JAX tests
# ---------------------------------------------------------------------------

def test_load_numpy_mid_circuit_then_continue(world):
    """JAX's state and layout taken mid-circuit, loaded into the port and
    continued on both engines."""
    _, port, jax_out = world
    N, first = c_load_first()
    _, rest = c_load_rest()
    _close(port["load"]["loaded"], jax_out["load"]["loaded"])
    _close(port["load"]["dense"], dense_run(N, first + rest))
    _close(port["load"]["dense"], jax_out["load"]["dense"])
    assert port["load"]["slot_of"] == jax_out["load"]["slot_of"]


def test_planner_a2a_count_equals_jax(world):
    """Every slab plan, planned or in circuit order, is JAX's, collective
    swaps and all."""
    _, port, jax_out = world
    for p in (False, True):
        got, want = port["planner"][p]["plan"], jax_out["planner"][p]["plan"]
        assert _a2a(got) == _a2a(want) > 0
        assert got == want
