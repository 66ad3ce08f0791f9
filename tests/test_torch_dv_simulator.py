"""The port's qubit toolbox (``dv/qop``) and its sequential DV engine
(``dv/simulator``: ``Simulator``, ``ClassicalControl``, ``parse_state``)
against the JAX package, on the CPU.

The same inputs (numpy, from a seed) go through both packages at x64; the
port's circuits are the JAX circuits with each gate rebuilt from the
port's classes. Sampled outcomes come from two different generators, so
the port runs with the JAX run's outcomes forced (``result=``) and the
states are compared. Tolerances: host-numpy builders exactly; tensor
functions to 1e-12 (the same float64 arithmetic in another order), except
the density-matrix fidelity (tr sqrt(a b))^2 at 1e-7, whose square roots
of rounding-level eigenvalues (~1e-16) each add up to ~1e-8; whole
circuits to 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quantum_computations_tpu.dv import qop as jqop
from quantum_computations_tpu.dv import gates as jgates
from quantum_computations_tpu.dv import Simulator as JSim, ClassicalControl as JCC
from quantum_computations_tpu.dv import State as JState, parse_state as jparse
from quantum_computations_tpu.pipelines import circuits
from quantum_computations_tpu_torch.dv import qop as tqop
from quantum_computations_tpu_torch.dv import gates as tgates
from quantum_computations_tpu_torch.dv import Simulator as TSim, ClassicalControl as TCC
from quantum_computations_tpu_torch.dv import State as TState, parse_state as tparse

TOL = 1e-12
DM_FID_TOL = 1e-7
RUN_TOL = 1e-10
rng = np.random.default_rng(0)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _ket(n):
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    return psi / np.linalg.norm(psi)


def _rand_u(d):
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q


# ---------------------------------------------------------------------------
# host builders
# ---------------------------------------------------------------------------

PAULI_IDS = ["i", "X", "y", "Z", "-x", "-Y", "-z", 0, 2, -3, (1, 0, 0),
             [0, -1, 0], np.array([0, 0, 1])]


@pytest.mark.parametrize("ident", PAULI_IDS, ids=str)
def test_pauli_helpers_match_jax(ident):
    assert tqop.get_pauli_number(ident) == jqop.get_pauli_number(ident)
    assert tqop.get_pauli_identifier(ident) == jqop.get_pauli_identifier(ident)
    assert tqop.is_pauli(ident)
    if tqop.get_pauli_number(ident) > 0:
        np.testing.assert_array_equal(tqop.get_pauli_operator(ident),
                                      jqop.get_pauli_operator(ident))
        for k in (0, 1):
            np.testing.assert_array_equal(tqop.get_pauli_state(ident, k),
                                          jqop.get_pauli_state(ident, k))


def test_pauli_errors_and_host_builders_match_jax():
    for bad in ("w", 4, (1, 1, 0), None):
        assert not tqop.is_pauli(bad)
        with pytest.raises(tqop.PauliError):
            tqop.get_pauli_number(bad)
    assert issubclass(tqop.PauliError, ValueError)
    for ident, n in (("0110", None), ([1, 0, 1], None), (5, 3), (np.int64(2), 2)):
        np.testing.assert_array_equal(tqop.basis_state(ident, n), jqop.basis_state(ident, n))
    with pytest.raises(TypeError):
        tqop.basis_state(3)
    with pytest.raises(NotImplementedError):
        tqop.basis_state(1.5)
    for th, ph in ((0.3, 1.1), (np.pi, -0.4)):
        np.testing.assert_array_equal(tqop.qubit_from_polar(th, ph), jqop.qubit_from_polar(th, ph))
    for axis in ((1, 2, 3), (0, 0, -1), (0.5, -0.2, 0.1)):
        np.testing.assert_array_equal(tqop.qubit_from_axis(axis), jqop.qubit_from_axis(axis))
    np.testing.assert_array_equal(tqop.euler_rotation(0.1, 0.2, 0.3),
                                  jqop.euler_rotation(0.1, 0.2, 0.3))
    np.testing.assert_array_equal(tqop.phase_gate(0.7), jqop.phase_gate(0.7))
    for n in (0, 1, 3, 4, 12, 64):
        assert tqop.is_power_of_two(n) == jqop.is_power_of_two(n)
    for a in (np.eye(4), np.ones((2, 4)), np.ones(8), np.ones(6), np.eye(3)):
        assert tqop.is_qubit_operator(a) == jqop.is_qubit_operator(a)
        assert tqop.is_qubit_state(a) == jqop.is_qubit_state(a)
    assert tqop.num_qubits(16) == jqop.num_qubits(16) == 4
    assert tqop.num_qubits(torch.zeros(8, 8)) == jqop.num_qubits(np.zeros((8, 8))) == 3


def test_rand_ket():
    np.random.seed(0)
    k = tqop.rand_ket(4)
    assert k.shape == (4,) and abs(float(tqop.norm(k)) - 1) < 1e-12
    g = torch.Generator().manual_seed(3)
    a = tqop.rand_ket(8, g)
    b = tqop.rand_ket(8, torch.Generator().manual_seed(3))
    assert a.dtype == torch.complex128 and torch.equal(a, b)
    assert abs(float(tqop.norm(a)) - 1) < 1e-12
    assert not torch.equal(a, tqop.rand_ket(8, g))


# ---------------------------------------------------------------------------
# tensor functions
# ---------------------------------------------------------------------------

def test_state_functions_match_jax():
    psi, phi = _ket(2), _ket(2)
    rho = np.outer(psi, psi.conj())
    mixed = 0.7 * rho + 0.3 * np.outer(phi, phi.conj())
    t = torch.from_numpy
    _close(tqop.dagger(t(mixed + 1j)).numpy(), jqop.dagger(jnp.asarray(mixed + 1j)))
    assert tqop.is_hermitian(t(mixed)) and not tqop.is_hermitian(t(mixed + 1j))
    _close(tqop.ket2dm(t(psi)).numpy(), jqop.ket2dm(jnp.asarray(psi)))
    with pytest.raises(TypeError):
        tqop.ket2dm(t(rho))
    back = tqop.dm2ket(t(rho)).numpy()
    assert abs(abs(np.vdot(back, psi)) - 1) < 1e-12
    with pytest.raises(TypeError):
        tqop.dm2ket(t(mixed))
    with pytest.raises(TypeError):
        tqop.dm2ket(t(mixed + 1j))
    _close(tqop.dm2ket(t(mixed), strict=False).numpy(),
           jqop.dm2ket(jnp.asarray(mixed), strict=False))
    _close(float(tqop.norm(t(3 * psi))), float(jqop.norm(jnp.asarray(3 * psi))))
    _close(tqop.normalise(t(3 * psi)).numpy(), jqop.normalise(jnp.asarray(3 * psi)))
    _close(tqop.normalise(t(2 * mixed)).numpy(), jqop.normalise(jnp.asarray(2 * mixed)))
    with pytest.raises(ValueError):
        tqop.normalise(torch.zeros(2, 2, 2))
    assert tqop.compare_kets(t(psi), t(1j * psi)) and not tqop.compare_kets(t(psi), t(phi))
    assert tqop.compare_kets(psi, 2 * psi) == jqop.compare_kets(psi, 2 * psi)
    for a, b, tol in ((psi, phi, TOL), (psi, mixed, TOL), (mixed, phi, TOL),
                      (rho, mixed, DM_FID_TOL), (mixed, mixed, DM_FID_TOL)):
        _close(float(tqop.fidelity(t(a), t(b))),
               float(jqop.fidelity(jnp.asarray(a), jnp.asarray(b))), tol)
    _close(float(tqop.purity(t(mixed))), float(jqop.purity(jnp.asarray(mixed))))
    op = _rand_u(4) + _rand_u(4).conj().T
    _close(tqop.expect(t(op), t(psi)).numpy(), jqop.expect(op, jnp.asarray(psi)))
    _close(float(tqop.expecth(op, psi)), float(jqop.expecth(op, jnp.asarray(psi))))
    with pytest.raises(TypeError):
        tqop.expect(op, _ket(3))


def test_tensor_permute_expand_control_match_jax():
    a, b, c = rng.normal(size=2), _ket(1), _rand_u(2)
    _close(tqop.tensor(a, b).numpy(), jqop.tensor(a, b))
    _close(tqop.tensor(c, np.eye(2), c).numpy(), jqop.tensor(c, np.eye(2), c))
    assert tqop.tensor(torch.from_numpy(a)).dtype == torch.float64
    psi, U = _ket(3), _rand_u(8)
    for order in ([2, 0, 1], [0, 2, 1], [1, 2, 0]):
        _close(tqop.permute_tensor_product(psi, order).numpy(),
               jqop.permute_tensor_product(jnp.asarray(psi), order))
        _close(tqop.permute_tensor_product(torch.from_numpy(U), order).numpy(),
               jqop.permute_tensor_product(jnp.asarray(U), order))
    for bad in ([0, 1], [0, 0, 1]):
        with pytest.raises(ValueError):
            tqop.permute_tensor_product(psi, bad)
    with pytest.raises(ValueError):
        tqop.permute_tensor_product(np.ones(6), [0])
    G = _rand_u(4)
    for N, targets in ((3, [2, 0]), (4, [1, 3]), (2, [1, 0])):
        _close(tqop.expand_gate(G, N, targets).numpy(), jqop.expand_gate(G, N, targets))
    _close(tqop.add_control(np.asarray(tqop.X)).numpy(), tqop.CX)
    V = _rand_u(4)
    _close(tqop.add_control(V).numpy(), jqop.add_control(V))


@pytest.mark.parametrize("N,targets", [(1, (0,)), (3, (1,)), (3, (0, 2)), (4, (2, 0)),
                                       (5, (4, 1, 3))])
def test_apply_unitary_matches_jax(N, targets):
    U, psi = _rand_u(2 ** len(targets)), _ket(N)
    _close(tqop.apply_unitary(torch.from_numpy(psi), U, targets).numpy(),
           jqop.apply_unitary(jnp.asarray(psi), U, targets))
    rho = np.outer(psi, _ket(N).conj())
    _close(tqop.apply_unitary_dm(torch.from_numpy(rho), U, targets).numpy(),
           jqop.apply_unitary_dm(jnp.asarray(rho), U, targets))


@pytest.mark.parametrize("N,targets", [(6, (0,)), (6, (5,)), (6, (3,)), (7, (1, 4)),
                                       (7, (4, 1)), (7, (0, 6)), (7, (5, 6))])
def test_apply_unitary_grouped_matches_jax(N, targets):
    u, psi = _rand_u(2 ** len(targets)), _ket(N)
    got = tqop.apply_unitary_grouped(torch.from_numpy(psi), u, targets).numpy()
    _close(got, jqop.apply_unitary_grouped(jnp.asarray(psi), jnp.asarray(u), targets))
    _close(got, tqop.apply_unitary(torch.from_numpy(psi), u, targets).numpy())
    with pytest.raises(NotImplementedError):
        tqop.apply_unitary_grouped(torch.from_numpy(psi), _rand_u(8), (0, 1, 2))


# ---------------------------------------------------------------------------
# the DV engine
# ---------------------------------------------------------------------------

def _port(gate, forced=None):
    """The port's counterpart of a JAX circuit element; ``forced`` gives a
    measurement its outcome."""
    if isinstance(gate, JCC):
        return TCC(_port(gate.gate), gate._pos, gate._neg)
    name = type(gate).__name__
    if name == "Insert":
        return tgates.Insert(gate.indices[0], TState[gate.state.name])
    if name == "M":
        return tgates.M(gate.indices[0], gate.theta, gate.phi, result=forced)
    if name in ("MZ", "MX"):
        return getattr(tgates, name)(gate.indices[0], result=forced)
    if name == "RZ":
        return tgates.RZ(gate.indices[0], gate.angle)
    return getattr(tgates, name)(*gate.indices)


def _run_both(circuit, init=None, seed=0):
    jsim = JSim(circuit, rng_seed=seed)
    want = np.asarray(jsim.run(init))
    forced = iter(jsim.results)
    port = [_port(g, next(forced) if isinstance(g, jgates.M) else None) for g in circuit]
    tsim = TSim(port, rng_seed=seed, device="cpu")
    t_init = None if init is None else (
        [TState[s.name] for s in init] if isinstance(init, list) else init)
    got = tsim.run(t_init)
    assert got.dtype == torch.complex128
    assert tsim.results == jsim.results
    _close(got.numpy(), want, RUN_TOL)
    return got, tsim.results


@pytest.mark.parametrize("tagged", [[3, 6], [0, 4], [2, 7]])
def test_grover_matches_jax(tagged):
    got, _ = _run_both(circuits.grover(circuits.oracle(tagged)))
    np.testing.assert_allclose(got.abs().numpy()[tagged] ** 2, 0.5, atol=1e-10)


def test_measurements_and_feed_forward_match_jax():
    circ = [jgates.Insert(0, JState.PLUS), jgates.Insert(1, JState.ZERO),
            jgates.Insert(2, JState.H), jgates.H(1), jgates.CX(1, 2), jgates.T(0),
            jgates.RZ(2, 0.3), jgates.MZ(0), JCC(jgates.X(1), positive_indices=[0]),
            jgates.MX(1), JCC(jgates.Z(2), negative_indices=[-1]),
            jgates.M(2, 0.4, 1.1), JCC(jgates.SWAP(0, 1), [0], [1]), jgates.CZ(0, 2)]
    for seed in range(4):
        _run_both(circ, seed=seed)
    _run_both([jgates.H(0), jgates.CX(0, 1), jgates.MZ(1)], init=[JState.ONE, JState.MINUS])
    _run_both([jgates.H(1), jgates.P(1), jgates.MZ(0)], init=_ket(2))


def test_postselection_classical_control_and_statistics():
    sim = TSim([tgates.Insert(0, TState.PLUS), tgates.MZ(0, result=1)], device="cpu")
    np.testing.assert_allclose(sim.run().abs().numpy(), [0, 1], atol=1e-12)
    assert sim.results == [1]
    circ = [tgates.Insert(0, TState.ONE), tgates.Insert(1, TState.ZERO), tgates.MZ(0),
            TCC(tgates.X(1), positive_indices=[0])]
    np.testing.assert_allclose(TSim(circ, rng_seed=0, device="cpu").run().abs().numpy(),
                               [0, 0, 0, 1], atol=1e-12)
    circ[-1] = TCC(tgates.X(1), negative_indices=[0])
    np.testing.assert_allclose(TSim(circ, rng_seed=0, device="cpu").run().abs().numpy(),
                               [0, 0, 1, 0], atol=1e-12)
    sim = TSim([tgates.Insert(0, TState.ZERO), tgates.MX(0, result=0)], device="cpu")
    np.testing.assert_allclose(sim.run().numpy(), np.array([1, 1]) / np.sqrt(2), atol=1e-12)
    outcomes = []
    for seed in range(40):
        sim = TSim([tgates.Insert(0, TState.PLUS), tgates.MZ(0)], rng_seed=seed, device="cpu")
        sim.run()
        outcomes.append(sim.results[0])
    assert 5 < sum(outcomes) < 35
    first = TSim([tgates.Insert(0, TState.PLUS), tgates.MZ(0)] * 6, rng_seed=9, device="cpu")
    first.run()
    again = TSim(first.circuit, rng_seed=9, device="cpu")
    again.run()
    assert first.results == again.results


def test_as_fn_parse_state_and_validation():
    fn = TSim([tgates.MZ(0), tgates.H(0)]).as_fn()
    state, results = fn(tparse(np.array([0.0, 1.0]), "cpu"), torch.Generator())
    assert results == [1]
    _close(state.numpy(), np.array([1.0, -1.0]) / np.sqrt(2))
    for init in (None, [JState.PLUS, JState.T], np.array([0.6, 0.8j])):
        t_init = [TState[s.name] for s in init] if isinstance(init, list) else init
        got = tparse(t_init, "cpu")
        assert got.dtype == torch.complex128
        _close(got.numpy(), jparse(init))
    with pytest.raises(TypeError):
        tparse("zero", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tparse(None)
    for circ in ([tgates.H(1)], [tgates.Insert(2, TState.ZERO)],
                 [tgates.Insert(0, TState.ZERO), TCC(tgates.X(1), [0])]):
        with pytest.raises(ValueError):
            TSim(circ, device="cpu").run()
        with pytest.raises(ValueError):
            JSim([_jax(g) for g in circ]).run()
    with pytest.raises(ValueError):
        TSim([tgates.Insert(0, TState.ZERO), TCC(tgates.M(0, 0.1, 0.2), [0])],
             device="cpu").run()


def _jax(gate):
    """The JAX counterpart of a port gate (for the validation cases)."""
    if isinstance(gate, TCC):
        return JCC(_jax(gate.gate), gate._pos, gate._neg)
    if isinstance(gate, tgates.Insert):
        return jgates.Insert(gate.indices[0], JState[gate.state.name])
    return getattr(jgates, type(gate).__name__)(*gate.indices)


def test_forced_runs_draw_nothing():
    """A circuit whose measurements are all forced draws nothing: its
    state is the same for every seed."""
    circ = [tgates.Insert(0, TState.PLUS), tgates.Insert(1, TState.PLUS),
            tgates.MZ(0, result=0), tgates.MX(1, result=1)]
    a = TSim(circ, rng_seed=1, device="cpu").run()
    b = TSim(circ, rng_seed=2, device="cpu").run()
    assert torch.equal(a, b)
