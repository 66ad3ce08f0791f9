"""Qubit operator toolbox of the port (counterpart of
``quantum_computations_tpu/dv/qop.py``).

Constants, Pauli parsing, state constructors and matrix builders are host
numpy, as in the JAX package. The state functions take torch tensors (a
numpy array is taken as a CPU tensor) of shape ``(2**N,)`` or
``(2**N, 2**N)`` in big-endian qubit order and return tensors on the same
device; gates apply by tensordot on the rank-N view, never by building the
dense ``2^N x 2^N`` operator.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

from ..config import full_fp32_matmul

# ---------------------------------------------------------------------------
# Constants (host numpy)
# ---------------------------------------------------------------------------

ZERO, ONE = np.array([1.0, 0.0]), np.array([0.0, 1.0])
PLUS, MINUS = np.array([1.0, 1.0]) / np.sqrt(2), np.array([1.0, -1.0]) / np.sqrt(2)
IPLUS, IMINUS = np.array([1, 1j]) / np.sqrt(2), np.array([1, -1j]) / np.sqrt(2)

IDTY = np.identity(2)
X = np.array([[0.0, 1.0], [1.0, 0.0]])
Y = np.array([[0, -1j], [1j, 0]])
Z = np.array([[1.0, 0.0], [0.0, -1.0]])
PAULIS = [X, Y, Z]

H = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)

CZ = np.diag([1.0, 1.0, 1.0, -1.0])
CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=float)
SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=float)

P = np.diag([1.0, 1.0j])
T = np.diag([1.0, np.exp(1.0j * np.pi / 4.0)])


class PauliError(ValueError):
    pass


_PAULI_NUMBERS = {
    "i": 0, "I": 0, 0: 0,
    "x": 1, "X": 1, 1: 1, (1, 0, 0): 1,
    "y": 2, "Y": 2, 2: 2, (0, 1, 0): 2,
    "z": 3, "Z": 3, 3: 3, (0, 0, 1): 3,
    "-x": -1, "-X": -1, -1: -1, (-1, 0, 0): -1,
    "-y": -2, "-Y": -2, -2: -2, (0, -1, 0): -2,
    "-z": -3, "-Z": -3, -3: -3, (0, 0, -1): -3,
}


def get_pauli_number(pauli_identifier) -> int:
    key = tuple(pauli_identifier) if isinstance(pauli_identifier, (list, np.ndarray)) else pauli_identifier
    try:
        return _PAULI_NUMBERS[key]
    except (KeyError, TypeError):
        raise PauliError(f'"{pauli_identifier}" could not be interpreted as a Pauli operator')


def get_pauli_identifier(pauli_identifier) -> str:
    return ["-Z", "-Y", "-X", "I", "X", "Y", "Z"][get_pauli_number(pauli_identifier) + 3]


def is_pauli(case) -> bool:
    try:
        get_pauli_number(case)
        return True
    except PauliError:
        return False


def get_pauli_operator(pauli_identifier) -> np.ndarray:
    return PAULIS[get_pauli_number(pauli_identifier) - 1]


def get_pauli_states(pauli_identifier):
    return [[PLUS, MINUS], [IPLUS, IMINUS], [ZERO, ONE]][get_pauli_number(pauli_identifier) - 1]


def get_pauli_state(pauli_identifier, state_index: int) -> np.ndarray:
    return get_pauli_states(pauli_identifier)[state_index]


# ---------------------------------------------------------------------------
# State constructors and matrix builders (host numpy)
# ---------------------------------------------------------------------------

def basis_state(identifier, N: int | None = None) -> np.ndarray:
    """Computational basis state; identifier may be int, bitstring or bit list."""
    if isinstance(identifier, (list, tuple)):
        return basis_state("".join(str(b) for b in identifier))
    if isinstance(identifier, str):
        return basis_state(int(identifier, 2), len(identifier))
    if isinstance(identifier, (int, np.integer)):
        if N is None:
            raise TypeError("N is required when identifier is an int")
        state = np.zeros(2**N)
        state[identifier] = 1.0
        return state
    raise NotImplementedError(
        f"Could not generate basis state from identifier of type {type(identifier)}"
    )


def qubit_from_polar(theta: float, phi: float) -> np.ndarray:
    return np.cos(theta / 2) * ZERO + np.exp(1j * phi) * np.sin(theta / 2) * ONE


def qubit_from_axis(axis) -> np.ndarray:
    theta = np.arccos(axis[-1] / np.sqrt(sum(a**2 for a in axis)))
    phi = np.arctan2(axis[1], axis[0])
    return qubit_from_polar(theta, phi)


def phase_gate(theta: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * theta)]])


def axis_rotation(theta: float, axis) -> np.ndarray:
    return IDTY * np.cos(theta / 2) - 1j * sum(
        axis[i] * PAULIS[i] for i in range(3)
    ) * np.sin(theta / 2)


def euler_rotation(theta1, theta2, theta3) -> np.ndarray:
    return (
        axis_rotation(theta3, [1, 0, 0])
        @ axis_rotation(theta2, [0, 0, 1])
        @ axis_rotation(theta1, [1, 0, 0])
    )


def rand_ket(d: int = 2, generator: torch.Generator | None = None):
    """A random normalised ket of dimension d: from numpy's global generator
    without ``generator``, else a complex128 tensor drawn from it."""
    if generator is None:
        return normalise(np.random.rand(d) + 1j * np.random.rand(d))
    re = torch.rand(d, generator=generator, dtype=torch.float64,
                    device=generator.device)
    im = torch.rand(d, generator=generator, dtype=torch.float64,
                    device=generator.device)
    return normalise(torch.complex(re, im))


# ---------------------------------------------------------------------------
# Structure predicates (host)
# ---------------------------------------------------------------------------

def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def is_qubit_operator(oper) -> bool:
    return oper.ndim == 2 and oper.shape[0] == oper.shape[1] and is_power_of_two(oper.shape[0])


def is_qubit_state(state) -> bool:
    return state.ndim == 1 and is_power_of_two(state.shape[0])


def num_qubits(arr) -> int:
    """Qubits of a register size (an int), a ket or an operator (its rows)."""
    n = arr if isinstance(arr, int) else arr.shape[0]
    if not is_power_of_two(n):
        raise ValueError(f"register size {n} is not a power of two")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# State functions (torch tensors)
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, lists) as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _as_op(matrix, state: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(matrix), dtype=state.dtype,
                           device=state.device)


def _promoted(a, b):
    """Two arrays as tensors of their common dtype on a's device."""
    a, b = _t(a), _t(b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(device=a.device, dtype=dtype)


def dagger(array):
    return _t(array).swapaxes(-1, -2).conj().resolve_conj()


def is_hermitian(oper) -> bool:
    oper = _t(oper)
    return bool(torch.allclose(dagger(oper), oper))


def ket2dm(ket):
    ket = _t(ket)
    if ket.ndim != 1:
        raise TypeError("state is not a ket")
    return torch.outer(ket, ket.conj())


def dm2ket(dm, strict: bool = True):
    """Largest-eigenvector extraction; errors if dm is not (close to) pure."""
    dm = _t(dm)
    if not is_hermitian(dm):
        raise TypeError("input is not a density matrix")
    eigvals, eigvecs = torch.linalg.eigh(dm)
    rest = eigvals[:-1]
    if strict and not torch.allclose(rest, torch.zeros_like(rest), atol=1e-6):
        raise TypeError("density matrix does not represent a pure state")
    return normalise(eigvecs[:, -1])


def norm(ket):
    return torch.linalg.norm(_t(ket))


def normalise(state):
    state = _t(state)
    if state.ndim == 1:
        return state / torch.linalg.norm(state)
    if state.ndim == 2:
        return state / torch.trace(state)
    raise ValueError("State not ket nor density matrix.")


def compare_kets(a, b) -> bool:
    a, b = _promoted(a, b)
    return bool(torch.allclose(ket2dm(normalise(a)), ket2dm(normalise(b)), atol=1e-6))


@full_fp32_matmul()
def fidelity(a, b):
    """Fidelity for any ket/density-matrix combination, with the
    ``(tr sqrt(a @ b))^2`` convention in the dm/dm case."""
    a, b = _promoted(a, b)
    if a.ndim == 1 and b.ndim == 1:
        return torch.abs(torch.vdot(a, b)) ** 2
    if a.ndim == 1:
        return (a.conj() @ b @ a).real
    if b.ndim == 1:
        return (b.conj() @ a @ b).real
    eigvals = torch.clamp(torch.linalg.eigvals(a @ b).real, min=0.0)
    return torch.sum(torch.sqrt(eigvals)) ** 2


@full_fp32_matmul()
def purity(rho):
    rho = _t(rho)
    return torch.trace(rho @ rho).real


@full_fp32_matmul()
def expect(oper, state):
    oper, state = _promoted(oper, state)
    if not is_qubit_operator(oper) or not is_qubit_state(state) or oper.shape[0] != state.shape[0]:
        raise TypeError("incompatible operator and state vector")
    return state.conj() @ oper @ state


def expecth(oper, state):
    return expect(oper, state).real


def tensor(*arrays):
    """Kronecker product of any number of arrays (kets or operators), in
    their common dtype (at least float64) on the first one's device."""
    arrays = [_t(a) for a in arrays]
    device = arrays[0].device if arrays else torch.device("cpu")
    dtype = reduce(torch.promote_types, (a.dtype for a in arrays), torch.float64)
    one = torch.ones((), dtype=dtype, device=device)
    return reduce(torch.kron, (a.to(device=device, dtype=dtype) for a in arrays), one)


def _permutation_inverse(perm):
    res = [0] * len(perm)
    for i, p in enumerate(perm):
        res[p] = i
    return res


def permute_tensor_product(array, new_ordering):
    """Reorder the qubit tensor factors of a state vector or operator: the
    qubit at old position ``new_ordering[k]`` moves to position ``k``."""
    array = _t(array)
    n = array.shape[0]
    if not is_power_of_two(n):
        raise ValueError("Given array is not a qubit state nor operator")
    N = num_qubits(array)
    if set(new_ordering) != set(range(N)):
        raise ValueError("new_ordering must be a permutation of all qubits")
    inv = _permutation_inverse(list(new_ordering))
    if array.ndim == 1:
        return array.reshape((2,) * N).permute(inv).reshape(-1)
    if array.ndim == 2:
        res = array.reshape((2,) * (2 * N))
        return res.permute(inv + [N + p for p in inv]).reshape(n, n)
    raise ValueError("array must be a ket or an operator")


def expand_gate(gate, N: int, targets):
    """Dense ``2^N x 2^N`` expansion, for tests and small references."""
    missing = [i for i in range(N) if i not in targets]
    result = tensor(gate, *[IDTY] * len(missing))
    return permute_tensor_product(result, list(targets) + missing)


def add_control(gate):
    gate = _t(gate)
    eye = torch.eye(gate.shape[0], dtype=gate.dtype, device=gate.device)
    return tensor(np.outer(ZERO, ZERO), eye) + tensor(np.outer(ONE, ONE), gate)


def apply_unitary(state, matrix, targets: tuple[int, ...]):
    """Apply a k-qubit operator to qubits ``targets`` of a state vector.

    ``state``: complex, ``(2**N,)``; ``matrix``: ``(2**k, 2**k)``. One
    tensordot over the rank-N view, then the target axes go back in place.
    """
    state = _t(state)
    N = num_qubits(state)
    k = len(targets)
    psi = state.reshape((2,) * N)
    op = _as_op(matrix, state).reshape((2,) * (2 * k))
    with full_fp32_matmul():
        psi = torch.tensordot(op, psi, dims=(list(range(k, 2 * k)),
                                             list(targets)))
    current = list(targets) + [i for i in range(N) if i not in targets]
    return psi.permute([current.index(i) for i in range(N)]).reshape(-1)


@full_fp32_matmul()
def apply_unitary_grouped(state, matrix, targets: tuple[int, ...]):
    """:func:`apply_unitary` through axis-grouped views of rank <= 5
    ((outer, 2, mid, 2, inner)) instead of the rank-N view; k in {1, 2}."""
    state = _t(state)
    N = num_qubits(state)
    op = _as_op(matrix, state)
    if len(targets) == 1:
        q = targets[0]
        psi = state.reshape(1 << q, 2, 1 << (N - q - 1))
        return torch.einsum("bc,acj->abj", op, psi).reshape(-1)
    if len(targets) == 2:
        lo, hi = sorted(targets)
        u = op.reshape(2, 2, 2, 2)
        if targets[0] > targets[1]:  # the operator's factors are (t1, t2)
            u = u.permute(1, 0, 3, 2)
        psi = state.reshape(1 << lo, 2, 1 << (hi - lo - 1), 2, 1 << (N - hi - 1))
        return torch.einsum("xyce,ocmei->oxmyi", u, psi).reshape(-1)
    raise NotImplementedError("grouped application supports 1- and 2-qubit gates")


def apply_unitary_dm(rho, matrix, targets: tuple[int, ...]):
    """``U rho U^dagger`` on a ``(2**N, 2**N)`` density matrix: U on the row
    qubits and conj(U) on the column qubits of the 2N-qubit vector."""
    rho = _t(rho)
    n = rho.shape[0]
    N = num_qubits(rho)
    vec = apply_unitary(rho.reshape(-1), matrix, tuple(targets))
    vec = apply_unitary(vec, np.conj(np.asarray(matrix)),
                        tuple(t + N for t in targets))
    return vec.reshape(n, n)


def insert_qubit(state, ket1, index: int):
    """Tensor a fresh qubit in state ``ket1`` into position ``index``."""
    state = _t(state)
    N = num_qubits(state)
    psi = torch.kron(state, _as_op(ket1, state))
    # the new qubit is last (axis N); move it to ``index``
    order = list(range(index)) + [N] + list(range(index, N))
    return psi.reshape((2,) * (N + 1)).permute(order).reshape(-1)


def born_probability(state, index: int, eigvec) -> torch.Tensor:
    """Probability of projecting qubit ``index`` onto the state ``eigvec``."""
    state = _t(state)
    N = num_qubits(state)
    psi = state.reshape((2,) * N)
    proj = torch.tensordot(_as_op(eigvec, state).conj(), psi,
                           dims=([0], [index]))
    return torch.sum(proj.abs() ** 2)


def project_qubit(state, index: int, eigvec) -> torch.Tensor:
    """``|e><e|`` on qubit ``index`` (unnormalised, the qubit kept)."""
    state = _t(state)
    N = num_qubits(state)
    psi = state.reshape((2,) * N)
    e = _as_op(eigvec, state)
    amp = torch.tensordot(e.conj(), psi, dims=([0], [index]))
    psi = torch.tensordot(e, amp, dims=0)  # qubit axis back in front
    current = [index] + [i for i in range(N) if i != index]
    return psi.permute([current.index(i) for i in range(N)]).reshape(-1)
