"""Qubit operator toolbox of the port (counterpart of
``quantum_computations_tpu/dv/qop.py``).

Constants and matrix builders are host numpy, as in the JAX package (its
``qop.py:33-46``, ``phase_gate``, ``axis_rotation``). The state functions
take complex torch tensors of shape ``(2**N,)`` in big-endian qubit order
and apply a k-qubit operator by tensordot on the rank-N view, never by
building the dense ``2^N x 2^N`` operator. They serve the gate classes and
the tests' dense references.
"""

from __future__ import annotations

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


def phase_gate(theta: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * theta)]])


def axis_rotation(theta: float, axis) -> np.ndarray:
    return IDTY * np.cos(theta / 2) - 1j * sum(
        axis[i] * PAULIS[i] for i in range(3)
    ) * np.sin(theta / 2)


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def num_qubits(state: torch.Tensor) -> int:
    n = state.numel()
    if not is_power_of_two(n):
        raise ValueError(f"state size {n} is not a power of two")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# State functions (complex torch tensors)
# ---------------------------------------------------------------------------

def _as_op(matrix, state: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(matrix), dtype=state.dtype,
                           device=state.device)


def apply_unitary(state: torch.Tensor, matrix, targets: tuple[int, ...]):
    """Apply a k-qubit operator to qubits ``targets`` of a state vector.

    ``state``: complex, ``(2**N,)``; ``matrix``: ``(2**k, 2**k)``. One
    tensordot over the rank-N view, then the target axes go back in place.
    """
    N = num_qubits(state)
    k = len(targets)
    psi = state.reshape((2,) * N)
    op = _as_op(matrix, state).reshape((2,) * (2 * k))
    with full_fp32_matmul():
        psi = torch.tensordot(op, psi, dims=(list(range(k, 2 * k)),
                                             list(targets)))
    current = list(targets) + [i for i in range(N) if i not in targets]
    return psi.permute([current.index(i) for i in range(N)]).reshape(-1)


def apply_unitary_dm(rho: torch.Tensor, matrix, targets: tuple[int, ...]):
    """``U rho U^dagger`` on a ``(2**N, 2**N)`` density matrix: U on the row
    qubits and conj(U) on the column qubits of the 2N-qubit vector."""
    n = rho.shape[0]
    N = num_qubits(rho[0])
    vec = apply_unitary(rho.reshape(-1), matrix, tuple(targets))
    vec = apply_unitary(vec, np.conj(np.asarray(matrix)),
                        tuple(t + N for t in targets))
    return vec.reshape(n, n)


def insert_qubit(state: torch.Tensor, ket1, index: int):
    """Tensor a fresh qubit in state ``ket1`` into position ``index``."""
    N = num_qubits(state)
    psi = torch.kron(state, _as_op(ket1, state))
    # the new qubit is last (axis N); move it to ``index``
    order = list(range(index)) + [N] + list(range(index, N))
    return psi.reshape((2,) * (N + 1)).permute(order).reshape(-1)


def born_probability(state: torch.Tensor, index: int, eigvec) -> torch.Tensor:
    """Probability of projecting qubit ``index`` onto the state ``eigvec``."""
    N = num_qubits(state)
    psi = state.reshape((2,) * N)
    proj = torch.tensordot(_as_op(eigvec, state).conj(), psi,
                           dims=([0], [index]))
    return torch.sum(proj.abs() ** 2)


def project_qubit(state: torch.Tensor, index: int, eigvec) -> torch.Tensor:
    """``|e><e|`` on qubit ``index`` (unnormalised, the qubit kept)."""
    N = num_qubits(state)
    psi = state.reshape((2,) * N)
    e = _as_op(eigvec, state)
    amp = torch.tensordot(e.conj(), psi, dims=([0], [index]))
    psi = torch.tensordot(e, amp, dims=0)  # qubit axis back in front
    current = [index] + [i for i in range(N) if i != index]
    return psi.permute([current.index(i) for i in range(N)]).reshape(-1)
