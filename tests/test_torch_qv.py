"""Quantum-volume circuits through the port's slab engine against the plain
reference (``reference/statevector``), and the engine's readouts, spans
and counters that the benchmark's ``qv30_d30`` cell reads.

QV circuits (arXiv:1811.12926) put Haar-random SU(4) on random, unsorted,
non-adjacent pairs, so fusion, the window planner and the layout passes get
no structure to exploit and leave the layout scrambled. On the CPU the
windows run ``slab_matmul_plain`` in full FP32.
"""

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.dv import FastStatevector
from quantum_computations_tpu_torch.dv import fast_sv as tfsv
from quantum_computations_tpu_torch.reference import statevector as ref
from quantum_computations_tpu_torch.utils import profiling

# float32 planes: each window product rounds at ~6e-8 relative over <= 128
# terms, and the windows' float32 matrices are unitary to ~1e-7; over the
# <= 450 windows here the relative error reads ~1e-6 (1.1e-6 at N = 10).
# A product with TF32 inputs reads ~1e-1 on the same circuits.
AMP_RTOL = 1e-5


def _rel_err(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _engine(n, **attrs) -> FastStatevector:
    sv = FastStatevector(n, device="cpu")
    for k, v in attrs.items():
        setattr(sv, k, v)
    return sv


@pytest.mark.parametrize("n,attrs,decomp", [
    (10, {}, None),
    (12, {}, None),
    (11, {"slab_bits": 3, "scatter_move_max": 0}, None),
    (12, {"slab_bits": 3, "scatter_move_max": 0}, "1"),
], ids=["default-n10", "default-n12", "minor-safe-3bit", "minor-safe-3bit-decomposed"])
def test_quantum_volume_matches_reference_on_every_amplitude(n, attrs, decomp, monkeypatch):
    """QV at N = 10-12 through ``run_compiled``, every amplitude through
    ``amplitudes``. The 3-bit slab with ``scatter_move_max`` lowered runs
    the minor-safe pass sequence (moves and block swaps) that N = 30
    takes; QCT_SV_MOVE_DECOMP=1 its per-run decomposed moves, as above
    2 GiB a plane."""
    if decomp is not None:
        monkeypatch.setenv("QCT_SV_MOVE_DECOMP", decomp)
    gates = ref.quantum_volume(n, n, np.random.default_rng(100 + n))
    sv = _engine(n, **attrs).run_compiled(gates)
    assert sv.axis_of != list(range(n))  # the layout is left scrambled
    psi = ref.simulate(gates, n).numpy()
    assert _rel_err(sv.amplitudes(np.arange(1 << n)), psi) < AMP_RTOL
    if attrs:
        seen = []
        real = tfsv._layout_copies
        monkeypatch.setattr(tfsv, "_layout_copies",
                            lambda op, N, S: seen.append(op[0]) or real(op, N, S))
        _engine(n, **attrs).run_compiled(gates)
        assert {"move", "swap"} <= set(seen) and "scatter" not in seen


def test_amplitudes_square_to_probs_on_the_identity_layout():
    rng = np.random.default_rng(3)
    n = 9
    re, im = rng.normal(size=(2, 1 << n)).astype(np.float32)
    sv = FastStatevector(n, device="cpu").load_numpy(re, im, range(n))
    amps = sv.amplitudes(np.arange(1 << n))
    np.testing.assert_array_equal(amps, re + 1j * im)
    np.testing.assert_allclose(np.abs(amps) ** 2, sv.probs().numpy(), rtol=1e-6)


@pytest.mark.parametrize("n", [9, 24])
def test_amplitudes_follow_a_scrambled_layout(n):
    """Planes in physical order under a random layout: each logical index
    reads the amplitude at its physical index. At N = 24 the layout has
    more runs than ``probs()`` takes."""
    rng = np.random.default_rng(n)
    re, im = rng.normal(size=(2, 1 << n)).astype(np.float32)
    axis_of = rng.permutation(n).tolist()
    sv = FastStatevector(n, device="cpu").load_numpy(re, im, axis_of)
    logical = rng.integers(1 << n, size=4096)
    physical = np.zeros_like(logical)
    for q, axis in enumerate(axis_of):
        physical |= ((logical >> (n - 1 - q)) & 1) << (n - 1 - axis)
    np.testing.assert_array_equal(sv.amplitudes(logical), re[physical] + 1j * im[physical])
    if n <= 22:
        full = (re + 1j * im).reshape((2,) * n).transpose(axis_of).reshape(-1)
        np.testing.assert_array_equal(sv.amplitudes(np.arange(1 << n)), full)
    with pytest.raises(ValueError):
        sv.amplitudes([1 << n])


def test_amplitudes_after_a_circuit_match_the_reference_on_a_scrambled_layout():
    n = 11
    gates = ref.quantum_volume(n, 6, np.random.default_rng(8))
    sv = FastStatevector(n, device="cpu").run(gates)
    assert sv.axis_of != list(range(n))
    picks = np.random.default_rng(9).integers(1 << n, size=300)
    psi = ref.simulate(gates, n).numpy()
    assert _rel_err(sv.amplitudes(picks), psi[picks]) < AMP_RTOL


def test_samples_have_a_cross_entropy_fidelity_near_one():
    """F_XEB = (2^N mean p(x) - 1) / (2^N sum p^2 - 1) over samples x of a
    scrambled state (layout scrambled too) is 1 in expectation, with a
    standard deviation of about sqrt(2 / shots) = 0.022 at 4096 shots; held
    within 5 of them."""
    n, shots = 12, 4096
    gates = ref.quantum_volume(n, n, np.random.default_rng(21))
    sv = FastStatevector(n, device="cpu").run_compiled(gates)
    assert sv.axis_of != list(range(n))
    x = sv.sample(torch.Generator().manual_seed(4), shots)
    p = np.abs(ref.simulate(gates, n).numpy()) ** 2
    f = (2**n * p[x].mean() - 1) / (2**n * np.sum(p * p) - 1)
    assert abs(f - 1) < 5 * np.sqrt(2 / shots)
    # the same samples read through the wrong bit order fail it
    y = np.zeros_like(x)
    for b in range(n):
        y |= ((x >> b) & 1) << (n - 1 - b)
    assert abs((2**n * p[y].mean() - 1) / (2**n * np.sum(p * p) - 1)) < 0.5


def test_haar_su4_draws_are_special_unitary_and_reproducible():
    draws = [ref.haar_su4(np.random.default_rng(s)) for s in (1, 1, 2)]
    for u in draws:
        np.testing.assert_allclose(u.conj().T @ u, np.eye(4), atol=1e-12)
        assert abs(np.linalg.det(u) - 1) < 1e-12
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.allclose(draws[0], draws[2])
    a, b = (ref.quantum_volume(7, 7, np.random.default_rng(5)) for _ in range(2))
    assert len(a) == 7 * 3
    for (ua, ta), (ub, tb) in zip(a, b):
        assert ta == tb and len(set(ta)) == 2
        np.testing.assert_array_equal(ua, ub)
    for layer in range(7):
        qubits = [q for _, t in a[3 * layer:3 * layer + 3] for q in t]
        assert len(set(qubits)) == 6  # disjoint pairs within a layer


def test_reference_matches_a_dense_product():
    """The slice-by-slice reference against Kronecker products of the
    whole register, for gates on sorted, unsorted and single targets."""
    n = 5
    rng = np.random.default_rng(13)
    gates = ref.quantum_volume(n, 3, rng)
    one = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0]
    gates += [(one, (2,)), (ref.haar_su4(rng), (4, 0))]
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for u, targets in gates:
        k = len(targets)
        rest = [q for q in range(n) if q not in targets]
        full = np.kron(u, np.eye(1 << (n - k))).reshape((2,) * (2 * n))
        order = list(targets) + rest
        inv = np.argsort(order)
        full = full.transpose(list(inv) + [n + int(i) for i in inv])
        psi = full.reshape(1 << n, 1 << n) @ psi
    np.testing.assert_allclose(ref.simulate(gates, n).numpy(), psi, atol=1e-13)


def test_tf32_inputs_fail_where_full_precision_passes():
    """The precision control: the reference with every gate product's
    inputs rounded to TF32 misses the float32 engine's tolerance by far."""
    n = 10
    gates = ref.quantum_volume(n, n, np.random.default_rng(1))
    psi = ref.simulate(gates, n).numpy()
    control = ref.simulate(gates, n, tf32_inputs=True).numpy()
    assert _rel_err(control, psi) > 1000 * AMP_RTOL


def test_reset_returns_to_zero_in_place():
    n = 10
    sv = FastStatevector(n, device="cpu").run_compiled(
        ref.quantum_volume(n, 4, np.random.default_rng(2)))
    planes = sv.re, sv.im
    sv.reset()
    assert sv.re is planes[0] and sv.im is planes[1]
    assert sv.axis_of == list(range(n))
    expected = np.zeros(1 << n, np.float32)
    expected[0] = 1
    np.testing.assert_array_equal(sv.re.numpy(), expected)
    assert not sv.im.any()


@pytest.mark.parametrize("compiled", [False, True])
def test_spans_and_counters(compiled, monkeypatch):
    """Under ``recording()`` the four ``op:sv_*`` spans appear; the plane
    copies and their bytes are what ``_layout_copies`` gives for the passes
    run, and each window is one ``op:sv_window`` span."""
    monkeypatch.setenv("QCT_SV_MOVE_DECOMP", "1")
    n = 12
    gates = ref.quantum_volume(n, n, np.random.default_rng(6))
    sv = _engine(n, slab_bits=3, scatter_move_max=0)
    ops = []
    real = sv._run_pass
    monkeypatch.setattr(sv, "_run_pass", lambda op: ops.append(op) or real(op))
    with profiling.recording():
        (sv.run_compiled if compiled else sv.run)(gates)
        sv.amplitudes([0, 1])
        sv.sample(torch.Generator().manual_seed(0), 8)
        sv.norm_sq()
    table = profiling.table()
    assert {"op:sv_plan", "op:sv_layout", "op:sv_window", "op:sv_readout"} <= set(table)
    copies = sum(2 * len(tfsv._layout_copies(op, n, 3)) for op in ops)
    assert ops and len(ops) == sv.layout_passes == table["op:sv_layout"]["calls"]
    assert sv.plane_copies == copies > 2 * len(ops)  # decomposed moves: several copies
    assert sv.layout_bytes == copies * 2 * 4 * (1 << n)
    assert sv.slab_windows == table["op:sv_window"]["calls"] > 0
    assert table["op:sv_readout"]["calls"] == 3
    assert table["op:sv_plan"]["calls"] == 1
