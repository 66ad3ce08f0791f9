"""The port's ``FastStatevector`` against the JAX engine: slab mode, and
chain mode against the JAX chain engine with its Pallas kernels in
interpret mode (same planner, so the plans must be identical).

The same gates (made from a numpy seed) run through the JAX
``FastStatevector`` in slab mode, on both of its paths (the Pallas
``slab_matmul`` in interpret mode, and XLA), and through the port on the
CPU. Both engines keep float32 planes and plan the same layout passes, so
the planes in physical order, ``axis_of`` and ``layout_passes`` are
compared directly. Tolerance: atol 2e-6 per amplitude and probability up
to N = 12 and 40 gates (float32 rounding of unit-norm states through
<= 128-wide window products, summed in different orders), 1e-5 for
``norm_sq`` (a float32 sum over 2^N terms). Planner outputs are numpy in
both engines and must be identical.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_computations_tpu.dv import gates as jgates
from quantum_computations_tpu.dv import fast_sv as jfsv
from quantum_computations_tpu.dv.states import State as JState
from quantum_computations_tpu_torch.dv import FastStatevector, State as TState
from quantum_computations_tpu_torch.dv import gates as tgates
from quantum_computations_tpu_torch.dv import fast_sv as tfsv
from quantum_computations_tpu_torch.dv import qop as tqop

ATOL = 2e-6
REPO = Path(__file__).resolve().parent.parent


def _rand_u(rng, k):
    d = 1 << k
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, _ = np.linalg.qr(a)
    return q.astype(np.complex64)


def _circuit(rng, n, n_gates):
    """1q rotations and 2q gates on scattered qubits: forces layout moves."""
    gates = []
    for _ in range(n_gates):
        k = 1 if rng.random() < 0.6 else 2
        tgts = tuple(int(t) for t in rng.choice(n, size=k, replace=False))
        gates.append((_rand_u(rng, k), tgts))
    return gates


def _jax_engine(n, path, **attrs):
    if path == "pallas":
        sv = jfsv.FastStatevector(n, fusion_mode="slab", use_pallas=True,
                                  interpret=True)
    else:
        sv = jfsv.FastStatevector(n, fusion_mode="slab", use_pallas=False)
    for k, v in attrs.items():
        setattr(sv, k, v)
    return sv


def _port_engine(n, **attrs):
    sv = FastStatevector(n, device="cpu")
    for k, v in attrs.items():
        setattr(sv, k, v)
    return sv


def _dense(gates, n):
    psi = torch.zeros(1 << n, dtype=torch.complex128)
    psi[0] = 1.0
    for m, t in gates:
        psi = tqop.apply_unitary(psi, m, t)
    return psi.numpy()


def _assert_same_state(port, jax_sv, atol=ATOL):
    assert port.axis_of == list(jax_sv.axis_of)
    assert port.layout_passes == jax_sv.layout_passes
    np.testing.assert_allclose(port.re.numpy(), np.asarray(jax_sv.re), atol=atol)
    np.testing.assert_allclose(port.im.numpy(), np.asarray(jax_sv.im), atol=atol)
    np.testing.assert_allclose(port.probs().numpy(), np.asarray(jax_sv.probs()),
                               atol=atol)
    assert abs(port.norm_sq() - jax_sv.norm_sq()) < 1e-5


@pytest.mark.parametrize("path", ["pallas", "xla"])
@pytest.mark.parametrize("compiled", [False, True])
def test_engine_matches_jax_slab(path, compiled):
    rng = np.random.default_rng(1)
    N = 12
    gates = _circuit(rng, N, 40)
    jsv = _jax_engine(N, path)
    tsv = _port_engine(N)
    for sv in (jsv, tsv):
        (sv.run_compiled if compiled else sv.run)(gates)
    assert not tsv._layout_is_identity()
    _assert_same_state(tsv, jsv)
    for qs in [(0,), (3, 1), (11, 0, 4), (2, 8, 5, 1)]:
        np.testing.assert_allclose(tsv.marginal(list(qs)).numpy(),
                                   np.asarray(jsv.marginal(list(qs))),
                                   atol=ATOL)
    for q in range(N):
        np.testing.assert_allclose(tsv.probabilities(q).numpy(),
                                   np.asarray(jsv.probabilities(q)),
                                   atol=ATOL)
    # and the physics: the dense complex128 reference
    np.testing.assert_allclose(tsv.probs().numpy(),
                               np.abs(_dense(gates, N)) ** 2, atol=ATOL)


def test_run_and_run_compiled_agree_twice():
    """Two compiled runs on an evolving layout equal two per-step runs."""
    rng = np.random.default_rng(2)
    N = 11
    gates = _circuit(rng, N, 16)
    a, b = _port_engine(N), _port_engine(N)
    for _ in range(2):
        a.run(gates)
        b.run_compiled(gates)
    assert a.axis_of == b.axis_of and a.layout_passes == b.layout_passes
    np.testing.assert_allclose(a.re.numpy(), b.re.numpy(), atol=ATOL)
    np.testing.assert_allclose(a.im.numpy(), b.im.numpy(), atol=ATOL)


@pytest.mark.parametrize("compiled", [False, True])
def test_minor_safe_large_n_moves(compiled):
    """S=4, N=15 and scatter_move_max=0: the block-swap / upper-move
    sequence in all its branches (resident, all-upper, mixed)."""
    rng = np.random.default_rng(7)
    N = 15
    windows = [[(_rand_u(rng, 1), (q,)) for q in (11, 12, 14)],
               [(_rand_u(rng, 1), (q,)) for q in (0, 2, 5)],
               [(_rand_u(rng, 1), (q,)) for q in (0, 3, 8)],
               _circuit(rng, N, 12)]
    attrs = dict(slab_bits=4, scatter_move_max=0)
    jsv = _jax_engine(N, "xla", **attrs)
    tsv = _port_engine(N, **attrs)
    for circ in windows:
        for sv in (jsv, tsv):
            (sv.run_compiled if compiled else sv.run)(circ)
    assert tsv.layout_passes > 0
    _assert_same_state(tsv, jsv)


def test_forced_move_decomposition(monkeypatch):
    """QCT_SV_MOVE_DECOMP=1 in both engines: the per-run middle swaps."""
    monkeypatch.setenv("QCT_SV_MOVE_DECOMP", "1")
    rng = np.random.default_rng(5)
    N = 15
    gates = _circuit(rng, N, 24)
    attrs = dict(slab_bits=4, scatter_move_max=0)
    jsv = _jax_engine(N, "xla", **attrs).run(gates)
    tsv = _port_engine(N, **attrs).run(gates)
    _assert_same_state(tsv, jsv)


def test_layout_pass_frees_each_plane_it_read(monkeypatch):
    """Each permute copy of a layout pass frees the plane it read (the
    engine keeps no reference), so at most three planes are ever live —
    at N = 30, 12 GiB rather than 16. Checked with weakrefs on the inputs
    of every copy, through the multi-copy decomposed moves."""
    import weakref

    monkeypatch.setenv("QCT_SV_MOVE_DECOMP", "1")
    inputs = []
    real = tfsv._permute_copy

    def spy(x, shape, perm):
        assert all(r() is None for r in inputs), "an earlier plane is alive"
        out = real(x, shape, perm)
        inputs.append(weakref.ref(x))
        return out

    monkeypatch.setattr(tfsv, "_permute_copy", spy)
    sv = _port_engine(15, slab_bits=4, scatter_move_max=0)
    sv.run_compiled(_circuit(np.random.default_rng(31), 15, 12))
    assert len(inputs) > 2 * sv.layout_passes  # decomposed: several copies


@pytest.mark.parametrize("decomp", ["0", "1"])
def test_upper_move_bit_identical(monkeypatch, decomp):
    import jax.numpy as jnp

    monkeypatch.setenv("QCT_SV_MOVE_DECOMP", decomp)
    N, S = 12, 5
    x = np.random.default_rng(11).normal(size=1 << N).astype(np.float32)
    for axes in [(0,), (6,), (0, 1), (2, 5), (0, 3, 6), (1, 2, 5, 6),
                 (4, 5, 6), (0, 2, 4, 6)]:
        for front in (False, True):
            want = np.asarray(jfsv._upper_move_raw(jnp.asarray(x), axes, N, S,
                                                   front))
            got = tfsv._upper_move_raw(torch.from_numpy(x), axes, N, S, front)
            np.testing.assert_array_equal(got.numpy(), want)
    for axes in [(0, 3, 9), (10, 11), (4,)]:
        np.testing.assert_array_equal(
            tfsv._move_axes_raw(torch.from_numpy(x), axes, N).numpy(),
            np.asarray(jfsv._move_axes_raw(jnp.asarray(x), axes, N)))
    np.testing.assert_array_equal(
        tfsv._block_swap_raw(torch.from_numpy(x), N, 4).numpy(),
        np.asarray(jfsv._block_swap_raw(jnp.asarray(x), N, 4)))


def test_plan_slab_residency_identical():
    rng = np.random.default_rng(11)
    for _ in range(200):
        N = int(rng.integers(4, 32))
        S = int(rng.integers(1, min(7, N) + 1))
        k = int(rng.integers(1, S + 1))
        phys = [int(p) for p in rng.choice(N, size=k, replace=False)]
        scatter_max = int(rng.choice([0, 21, N]))
        records = []
        for mod in (tfsv, jfsv):
            ops = []

            def emit(op, newpos):
                ops.append((op, tuple(newpos(p) for p in range(N))))

            final = mod.plan_slab_residency(N, S, scatter_max, phys, emit)
            records.append((ops, final))
        assert records[0] == records[1], (N, S, phys, scatter_max)


def test_order_windows_identical():
    rng = np.random.default_rng(13)
    for _ in range(20):
        N = int(rng.integers(8, 24))
        S = int(rng.integers(2, 8))
        layout = [int(p) for p in rng.permutation(N)]
        windows = [(np.eye(1 << len(t)), tuple(sorted(t)))
                   for _, t in _circuit(rng, N, 10)]
        scatter_max = int(rng.choice([0, 21]))
        got = tfsv.order_windows(windows, N, S, scatter_max, layout)
        want = jfsv.order_windows(windows, N, S, scatter_max, layout)
        assert [t for _, t in got] == [t for _, t in want]


def test_window_mode_matches_jax():
    rng = np.random.default_rng(3)
    N = 10
    gates = _circuit(rng, N, 20)
    jsv = jfsv.FastStatevector(N, fusion_mode="window").run(gates)
    tsv = FastStatevector(N, device="cpu", fusion_mode="window").run(gates)
    np.testing.assert_allclose(tsv.re.numpy(), np.asarray(jsv.re), atol=ATOL)
    np.testing.assert_allclose(tsv.im.numpy(), np.asarray(jsv.im), atol=ATOL)


def test_load_numpy_carries_jax_state_across():
    """Run half a circuit in JAX, finish it in the port."""
    rng = np.random.default_rng(17)
    N = 12
    gates = _circuit(rng, N, 30)
    first, second = gates[:15], gates[15:]
    jhalf = _jax_engine(N, "xla").run(first)
    assert not jhalf._layout_is_identity()
    tsv = _port_engine(N).load_numpy(np.asarray(jhalf.re), np.asarray(jhalf.im),
                                     jhalf.axis_of)
    tsv.run(second)
    jfull = _jax_engine(N, "xla").run(first).run(second)
    assert tsv.axis_of == list(jfull.axis_of)
    np.testing.assert_allclose(tsv.probs().numpy(), np.asarray(jfull.probs()),
                               atol=ATOL)
    re, im, axis_of = tsv.to_numpy()
    back = _port_engine(N).load_numpy(re, im, axis_of)
    assert torch.equal(back.re, tsv.re) and back.axis_of == tsv.axis_of
    with pytest.raises(ValueError):
        _port_engine(N).load_numpy(re[:-1], im, axis_of)
    with pytest.raises(ValueError):
        _port_engine(N).load_numpy(re, im, [0] * N)


def test_sample_histogram_matches_probs():
    """Chi-square of 20000 shots against probs() on a permuted layout
    (exercises the physical->logical remap). The PRNGs of the two
    frameworks differ, so distributions are compared, not draws.
    Threshold: the chi-square quantile at 1 - 1e-4 for the occupied cells
    (a false alarm once in 10^4 seeds; the seed is fixed)."""
    from scipy.stats import chi2

    rng = np.random.default_rng(19)
    N = 6
    gates = _circuit(rng, N, 12)
    sv = _port_engine(N, slab_bits=3).run(gates)
    assert not sv._layout_is_identity()
    shots = 20000
    samples = sv.sample(torch.Generator().manual_seed(0), shots)
    assert samples.shape == (shots,)
    p = sv.probs().double().numpy()
    np.testing.assert_allclose(p, np.abs(_dense(gates, N)) ** 2, atol=ATOL)
    counts = np.bincount(samples, minlength=1 << N)
    keep = p * shots > 5
    assert counts[~keep].sum() <= 5 * max(1, (~keep).sum())
    expected = p[keep] / p[keep].sum() * counts[keep].sum()
    stat = float(np.sum((counts[keep] - expected) ** 2 / expected))
    assert stat < chi2.ppf(1 - 1e-4, int(keep.sum()) - 1), stat


# -- chain mode ---------------------------------------------------------------
def _jax_chain(n):
    return jfsv.FastStatevector(n, use_pallas=True, interpret=True,
                                fusion_mode="chain")


def _jax_mixed_circuit():
    """The JAX package's own chain-mode circuit (tests/test_fast_sv.py):
    a chain, a 2q step, a non-adjacent and a small-inner general step."""
    gates = [jgates.H(0), jgates.H(1), jgates.H(2), jgates.CX(1, 2),
             jgates.T(0), jgates.P(1), jgates.CZ(4, 7), jgates.H(9),
             jgates.X(5), jgates.Y(6)]
    return [(np.asarray(g.matrix), tuple(g.indices)) for g in gates]


def _chain_circuit(rng, n, n_gates):
    """Random gates at N = 14 that plan every kind: 1q rotations (fusable
    on qubits 0..6), adjacent pairs, and general steps with unsorted
    targets (CX(5, 2) among them)."""
    gates = [(_rand_u(rng, 1), (q,)) for q in range(7)]
    gates += [(np.asarray(jgates.CX(5, 2).matrix), (5, 2))]
    for _ in range(n_gates):
        r = rng.random()
        if r < 0.55:
            gates.append((_rand_u(rng, 1), (int(rng.integers(n)),)))
        elif r < 0.8:
            q = int(rng.integers(n - 1))
            gates.append((_rand_u(rng, 2), (q, q + 1)))
        else:
            t = tuple(int(x) for x in rng.choice(n, 2, replace=False))
            gates.append((_rand_u(rng, 2), t))
    return gates


def _assert_chain_readouts(tsv, jsv):
    assert tsv._layout_is_identity()
    np.testing.assert_allclose(tsv.re.numpy(), np.asarray(jsv.re), atol=ATOL)
    np.testing.assert_allclose(tsv.im.numpy(), np.asarray(jsv.im), atol=ATOL)
    np.testing.assert_allclose(tsv.probs().numpy(), np.asarray(jsv.probs()),
                               atol=ATOL)
    N = tsv.N
    for qs in [(0,), (N - 1, 2), (3, 0, N - 2)]:
        np.testing.assert_allclose(tsv.marginal(list(qs)).numpy(),
                                   np.asarray(jsv.marginal(list(qs))),
                                   atol=ATOL)
    for q in (0, N // 2, N - 1):
        np.testing.assert_allclose(tsv.probabilities(q).numpy(),
                                   np.asarray(jsv.probabilities(q)),
                                   atol=ATOL)
    assert abs(tsv.norm_sq() - jsv.norm_sq()) < 1e-5


def _kinds(plans):
    return [p.kind for p in plans]


def test_chain_engine_matches_jax_on_its_own_circuit():
    N = 10
    gates = _jax_mixed_circuit()
    jsv = _jax_chain(N).run(gates)
    tsv = FastStatevector(N, device="cpu", fusion_mode="chain").run(gates)
    assert set(_kinds(tsv._plan(gates))) == {"chain", "2q", "xla"}
    _assert_chain_readouts(tsv, jsv)
    np.testing.assert_allclose(tsv.probs().numpy(),
                               np.abs(_dense(gates, N)) ** 2, atol=ATOL)


def test_chain_engine_matches_jax_random_circuit():
    rng = np.random.default_rng(37)
    N = 14
    gates = _chain_circuit(rng, N, 20)
    tsv = FastStatevector(N, device="cpu", fusion_mode="chain").run(gates)
    kinds = _kinds(tsv._plan(gates))
    assert {"chain", "2q", "xla"} <= set(kinds)
    jsv = _jax_chain(N).run(gates)
    _assert_chain_readouts(tsv, jsv)
    np.testing.assert_allclose(tsv.probs().numpy(),
                               np.abs(_dense(gates, N)) ** 2, atol=ATOL)


def _jax_planner(n):
    """A JAX chain engine that plans but holds no planes (N = 30 would
    allocate 8 GiB): the fields ``_plan`` reads, set as the JAX engine's
    ``__init__`` sets them."""
    from quantum_computations_tpu.ops import pallas_kernels as pk

    sv = object.__new__(jfsv.FastStatevector)
    sv.N, sv.use_pallas = n, True
    c_bits = min(jfsv.FastStatevector.C_BITS, n - 1)
    block_rows = min(jfsv.FastStatevector.BLOCK_ROWS, 1 << (n - c_bits))
    sv._fusable = set(pk.fusable_bits(n, c_bits, block_rows))
    if n <= 16:
        assert sv._fusable == _jax_chain(n)._fusable
    return sv


def _same_plans(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.kind, list(g.bits), tuple(g.targets)) == \
            (w.kind, list(w.bits), tuple(w.targets))
        assert len(g.matrices) == len(w.matrices)
        for a, b in zip(g.matrices, w.matrices):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N", [10, 14, 16, 30])
def test_chain_plan_identical_to_jax(N):
    """Planning only (no planes touched): the port's plan equals JAX's
    gate for gate. The port plans on the meta device at N = 30."""
    rng = np.random.default_rng(N)
    tsv = FastStatevector(N, device="meta" if N > 16 else "cpu",
                          fusion_mode="chain")
    jsv = _jax_planner(N)
    assert tsv._fusable == jsv._fusable
    for _ in range(5):
        gates = _circuit(rng, N, 60)
        # adjacent pairs, and runs of fusable 1q gates, on every qubit
        gates += [(_rand_u(rng, 2), (q, q + 1)) for q in range(N - 1)]
        gates += [(_rand_u(rng, 1), (q,)) for q in range(N)] * 2
        gates += [jgates.Insert(1, JState.T)]
        _same_plans(tsv._plan(gates), jsv._plan(gates))


def test_chain_longer_than_24_splits_as_in_jax():
    N = 12
    rng = np.random.default_rng(3)
    gates = [(_rand_u(rng, 1), (int(q),)) for q in rng.integers(0, 5, 30)]
    tsv = FastStatevector(N, device="cpu", fusion_mode="chain")
    plans = tsv._plan(gates)
    assert [len(p.bits) for p in plans] == [24, 6]
    _same_plans(plans, _jax_planner(N)._plan(gates))
    tsv.run(gates)
    np.testing.assert_allclose(tsv.probs().numpy(),
                               np.abs(_dense(gates, N)) ** 2, atol=ATOL)


def test_load_numpy_carries_jax_chain_state_across():
    """Run half a circuit in the JAX chain engine, finish it in the port's."""
    rng = np.random.default_rng(47)
    N = 12
    gates = _chain_circuit(rng, N, 10)
    first, second = gates[:9], gates[9:]
    jhalf = _jax_chain(N).run(first)
    tsv = FastStatevector(N, device="cpu", fusion_mode="chain").load_numpy(
        np.asarray(jhalf.re), np.asarray(jhalf.im), jhalf.axis_of)
    tsv.run(second)
    jfull = jhalf.run(second)
    _assert_chain_readouts(tsv, jfull)


def _permuted_state(case):
    """(N, re, im, axis_of, second half, JAX slab engine after it) for a
    state in a non-identity slab layout."""
    import jax.numpy as jnp

    if case == "jax_half":
        rng = np.random.default_rng(53)
        N = 12
        gates = _circuit(rng, N, 30)
        first, second = gates[:15], gates[15:]
        jsv = _jax_engine(N, "xla").run(first)
        assert not jsv._layout_is_identity()
        re, im, axis_of = np.asarray(jsv.re), np.asarray(jsv.im), \
            list(jsv.axis_of)
    else:  # logical axes 0 and 8 swapped at N = 16, then R(0.3) and H
        rng = np.random.default_rng(59)
        N = 16
        amp = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
        amp /= np.linalg.norm(amp)
        re, im = amp.real.astype(np.float32), amp.imag.astype(np.float32)
        axis_of = list(range(N))
        axis_of[0], axis_of[8] = 8, 0
        second = [(tqop.axis_rotation(0.3, np.array([1.0, 0.0, 0.0])), (8,)),
                  (np.asarray(tgates.H(0).matrix), (0,))]
        jsv = _jax_engine(N, "xla")
        jsv.re, jsv.im, jsv.axis_of = jnp.asarray(re), jnp.asarray(im), \
            list(axis_of)
    return N, re, im, axis_of, second, jsv.run(second)


@pytest.mark.parametrize("case", ["jax_half", "swap_0_8"])
def test_loaded_layout_in_window_and_chain_mode(case):
    """A state in a permuted slab layout, loaded into window and chain
    mode, gives the JAX slab engine's and the port's slab-mode probs()."""
    N, re, im, axis_of, second, jref = _permuted_state(case)
    slab = _port_engine(N).load_numpy(re, im, axis_of).run(second)
    assert not slab._layout_is_identity()
    np.testing.assert_allclose(slab.probs().numpy(), np.asarray(jref.probs()),
                               atol=ATOL)
    for mode in ("chain", "window"):
        tsv = FastStatevector(N, device="cpu", fusion_mode=mode).load_numpy(
            re, im, axis_of)
        assert tsv._layout_is_identity()
        tsv.run(second)
        np.testing.assert_allclose(tsv.probs().numpy(),
                                   np.asarray(jref.probs()), atol=ATOL)
        np.testing.assert_allclose(tsv.probs().numpy(), slab.probs().numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["chain", "window"])
def test_permuted_layout_outside_slab_mode_raises(mode):
    """run() in window or chain mode refuses a non-identity layout rather
    than applying gates to the wrong axes."""
    sv = FastStatevector(4, device="cpu", fusion_mode=mode)
    sv.axis_of = [1, 0, 2, 3]
    with pytest.raises(ValueError, match="identity layout"):
        sv.run([tgates.H(0)])


def test_chain_selected_by_env_and_run_compiled_refuses(monkeypatch):
    monkeypatch.setenv("QCT_SV_FUSION", "chain")
    sv = FastStatevector(4, device="cpu")
    assert sv.fusion_mode == "chain"
    with pytest.raises(ValueError, match="slab"):
        sv.run_compiled([tgates.H(0)])
    monkeypatch.setenv("QCT_SV_FUSION", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        FastStatevector(4, device="cpu")


@pytest.mark.parametrize("targets", [(5, 2), (3, 0, 6), (6, 1), (2, 7, 4)])
def test_general_step_matches_jax_unsorted(targets):
    """The plain general step on targets in gate order."""
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(targets))
    N = 8
    xr = rng.normal(size=1 << N).astype(np.float32)
    xi = rng.normal(size=1 << N).astype(np.float32)
    u = _rand_u(rng, len(targets))
    want = jfsv._apply_xla_general(jnp.asarray(xr), jnp.asarray(xi), u,
                                   targets, N)
    got = tfsv._apply_xla_general(torch.from_numpy(xr), torch.from_numpy(xi),
                                  u, targets, N)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_no_cuda_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastStatevector(4)


@pytest.mark.parametrize("cls", ["H", "T", "RZ", "CX", "CZ", "SWAP", "Y"])
def test_gates_apply_matches_jax(cls):
    import jax.numpy as jnp

    rng = np.random.default_rng(23)
    N = 4
    psi = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    psi /= np.linalg.norm(psi)
    args = {"RZ": (2, 0.37), "CX": (3, 1), "CZ": (0, 2), "SWAP": (1, 3)}
    a = args.get(cls, (1,))
    jg, tg = getattr(jgates, cls)(*a), getattr(tgates, cls)(*a)
    np.testing.assert_array_equal(tg.matrix, jg.matrix)
    assert tg.indices == jg.indices
    want = np.asarray(jg.apply(jnp.asarray(psi)))
    got = tg.apply(torch.from_numpy(psi)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    rho = np.outer(psi, psi.conj())
    np.testing.assert_allclose(tg.apply(torch.from_numpy(rho)).numpy(),
                               np.asarray(jg.apply(jnp.asarray(rho))),
                               atol=1e-12)


def test_measurement_and_insert_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(29)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    psi /= np.linalg.norm(psi)
    for result in (0, 1):
        for cls in ("MZ", "MX"):
            jst, js = getattr(jgates, cls)(1, result=result).apply(jnp.asarray(psi))
            tst, ts = getattr(tgates, cls)(1, result=result).apply(
                torch.from_numpy(psi))
            assert ts == int(js)
            np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-12)
    with pytest.raises(ValueError):
        tgates.MZ(0).apply(torch.from_numpy(psi))
    st, s = tgates.MZ(0).apply(torch.from_numpy(psi),
                               generator=torch.Generator().manual_seed(0))
    assert s in (0, 1) and abs(torch.linalg.norm(st).item() - 1) < 1e-12
    want = np.asarray(jgates.Insert(1, JState.T).apply(jnp.asarray(psi)))
    got = tgates.Insert(1, TState.T).apply(torch.from_numpy(psi)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    with pytest.raises(ValueError):
        tgates.CX(1, 1)


def test_port_imports_no_jax():
    """Importing the port pulls in neither jax nor the JAX package."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import quantum_computations_tpu_torch\n"
            "import quantum_computations_tpu_torch.dv\n"
            "import quantum_computations_tpu_torch.ops.slab_kernels\n"
            "import quantum_computations_tpu_torch.cv\n"
            "import quantum_computations_tpu_torch.ops.linalg\n"
            "import quantum_computations_tpu_torch.ops.interp\n"
            "import quantum_computations_tpu_torch.ops.streamed\n"
            "import quantum_computations_tpu_torch.dv.simulator\n"
            "import quantum_computations_tpu_torch.gkp\n"
            "import quantum_computations_tpu_torch.utils\n"
            "import quantum_computations_tpu_torch.ops.fused_gadget\n"
            "import quantum_computations_tpu_torch.gkp.batched\n"
            "import quantum_computations_tpu_torch.gkp.compiled\n"
            "import quantum_computations_tpu_torch.pipelines.rb_batched\n"
            "import quantum_computations_tpu_torch.pipelines.circuits\n"
            "import quantum_computations_tpu_torch.pipelines.grover\n"
            "import quantum_computations_tpu_torch.pipelines.rb\n"
            "import quantum_computations_tpu_torch.pipelines.grover_batched\n"
            "import quantum_computations_tpu_torch.pipelines.grover_compiled\n"
            "import quantum_computations_tpu_torch.pipelines.rb_compiled\n"
            "import quantum_computations_tpu_torch.pipelines.analysis\n"
            "import quantum_computations_tpu_torch.pipelines.tomography\n"
            "import quantum_computations_tpu_torch.pipelines.clifford_fidelity\n"
            "import quantum_computations_tpu_torch.pipelines.common\n"
            "import quantum_computations_tpu_torch.pipelines.cv_circuits\n"
            "import quantum_computations_tpu_torch.pipelines.gkp_ec\n"
            "import quantum_computations_tpu_torch.pipelines.gkp_ec_validation\n"
            "import quantum_computations_tpu_torch.utils.colour\n"
            "import quantum_computations_tpu_torch.distill\n"
            "import quantum_computations_tpu_torch.distill.explorer\n"
            "import quantum_computations_tpu_torch.distill.physical\n"
            "import quantum_computations_tpu_torch.distill.rates\n"
            "import quantum_computations_tpu_torch.distill.search\n"
            "import quantum_computations_tpu_torch.parallel\n"
            "import quantum_computations_tpu_torch.parallel.shardmap_sv\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'quantum_computations_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_name_no_jax():
    files = sorted((REPO / "quantum_computations_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 5
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "quantum_computations_tpu"}, \
            (f, roots)
