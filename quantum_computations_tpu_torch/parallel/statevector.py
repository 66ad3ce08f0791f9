"""Mesh-sharded DV state vector (counterpart of
``quantum_computations_tpu/parallel/statevector.py``).

The state is a rank-N tensor of shape (2,)*N whose first k axes are sharded
over a (2,)*k mesh of ranks (:func:`.mesh.qubit_mesh`, one binary mesh axis
per sharded qubit): each rank holds the (2,)*(N-k) block of its k leading
bits. Gates apply with the same contractions as the single-device engine.

The JAX package leaves the communication of a gate on a sharded axis to
the SPMD partitioner. Here it is explicit: each sharded target axis is
first exchanged with a local non-target axis (the pairwise exchange of
:func:`.shardmap_sv.pair_swap`), the gate applies locally, and the same
exchanges run again to restore the layout, so the state keeps its
sharding. Gates on local axes communicate nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype
from ..dv import qop
from .mesh import Mesh
from .shardmap_sv import agreed_outcome, pair_swap

__all__ = ["ShardedStateVector", "apply_gate_sharded", "state_spec"]


def state_spec(mesh: Mesh, N: int) -> tuple:
    """The sharding of the state's N axes: mesh axis name per axis (the
    first k), None for a local axis (JAX's ``PartitionSpec`` entries)."""
    k = len(mesh.axis_names)
    if k > N:
        raise ValueError(f"Mesh has {k} axes but state only {N} qubits.")
    return tuple(mesh.axis_names) + (None,) * (N - k)


def _apply_local(flat: torch.Tensor, matrix, targets: tuple[int, ...],
                 N: int) -> torch.Tensor:
    """k-qubit unitary on local axes of a flat block. 1- and 2-qubit gates
    of a large state take the axis-grouped path (rank <= 5 views), as the
    JAX engine does above 14 qubits."""
    if len(targets) <= 2 and N > 14:
        return qop.apply_unitary_grouped(flat, matrix, targets)
    return qop.apply_unitary(flat, matrix, targets)


def apply_gate_sharded(block: torch.Tensor, matrix, targets: tuple[int, ...],
                       mesh: Mesh) -> torch.Tensor:
    """Apply ``matrix`` to qubits ``targets`` of the sharded state whose
    block on this rank is ``block`` (shape (2,)*(N-k)); returns the new
    block, with the same sharding. Called by every rank of ``mesh``."""
    k = len(mesh.axis_names)
    L = block.dim()
    N = L + k
    targets = tuple(int(t) for t in targets)
    sharded = [t for t in targets if t < k]
    spare = [a for a in range(N - 1, k - 1, -1) if a not in targets]
    if len(sharded) > len(spare):
        raise ValueError(f"{len(targets)} targets on a state with {L} local "
                         "qubits per rank")
    swaps = list(zip(sharded, spare))  # (sharded axis, local axis)
    flat = block.contiguous().reshape(-1)
    for t, a in swaps:
        pair_swap(mesh, flat, k, t, a - k)
    on = dict(swaps)
    local = tuple(on.get(t, t) - k for t in targets)
    flat = _apply_local(flat, np.asarray(matrix), local, N).contiguous()
    for t, a in reversed(swaps):
        pair_swap(mesh, flat, k, t, a - k)
    return flat.reshape((2,) * L)


class ShardedStateVector:
    """N-qubit state vector distributed over a qubit mesh.

    ``self.state`` is this rank's block, shape (2,)*(N-k). Every rank calls
    every method in the same order.

    >>> mesh = qubit_mesh(3)          # 8 ranks
    >>> sv = ShardedStateVector(30, mesh)
    >>> sv.apply(qop.H, (29,))        # local axis: no communication
    >>> sv.apply(qop.CZ, (0, 29))     # sharded axis: pairwise exchanges
    """

    def __init__(self, N: int, mesh: Mesh, state: torch.Tensor | None = None):
        self.N = N
        self.mesh = mesh
        self.sharding = state_spec(mesh, N)
        self.k = len(mesh.axis_names)
        self.device = mesh.device
        if state is None:
            state = torch.zeros((2,) * (N - self.k), dtype=complex_dtype(self.device),
                                device=self.device)
            if mesh.rank == 0:
                state.view(-1)[0] = 1.0
        self.state = state

    # -- gates --------------------------------------------------------------
    def apply(self, matrix, targets: tuple[int, ...]) -> "ShardedStateVector":
        self.state = apply_gate_sharded(self.state, matrix, tuple(targets),
                                        self.mesh)
        return self

    def run_circuit(self, circuit: list[tuple[np.ndarray, tuple[int, ...]]]):
        """Apply a (matrix, targets) list, one gate after another."""
        for m, t in circuit:
            self.apply(m, t)
        return self

    # -- observables --------------------------------------------------------
    def _bit(self, axis: int) -> int:
        """This rank's coordinate on sharded axis ``axis``."""
        return (self.mesh.rank >> (self.k - 1 - axis)) & 1

    def probabilities(self, qubit: int) -> torch.Tensor:
        """Marginal (p0, p1) of one qubit, on every rank."""
        p = self.state.real ** 2 + self.state.imag ** 2
        if qubit < self.k:
            out = torch.zeros(2, dtype=p.dtype, device=self.device)
            out[self._bit(qubit)] = torch.sum(p)
        else:
            out = torch.sum(p.reshape(1 << (qubit - self.k), 2, -1), (0, 2))
        return self.mesh.all_reduce(out)

    def norm(self) -> torch.Tensor:
        p = self.state.real ** 2 + self.state.imag ** 2
        return torch.sqrt(self.mesh.all_reduce(torch.sum(p)))

    def expectation_z(self, qubit: int) -> torch.Tensor:
        p = self.probabilities(qubit)
        return p[0] - p[1]

    def amplitude(self, bits) -> torch.Tensor:
        """The amplitude of basis state ``bits`` (one bit per qubit),
        broadcast from the rank that holds it."""
        bits = [int(b) for b in bits]
        owner = int(sum(b << (self.k - 1 - i) for i, b in enumerate(bits[:self.k])))
        amp = torch.zeros((), dtype=self.state.dtype, device=self.device)
        if self.mesh.rank == owner:
            amp = self.state[tuple(bits[self.k:])].clone()
        return self.mesh.broadcast(amp, owner)

    def measure(self, qubit: int, generator: torch.Generator | None = None, *,
                result: int | None = None) -> int:
        """Sample a Z measurement on rank 0 (or post-select ``result``),
        broadcast it, and collapse. Returns the outcome."""
        s, p = agreed_outcome(self.mesh, *self.probabilities(qubit).tolist(),
                              generator, result)
        if qubit < self.k:
            if self._bit(qubit) != s:
                self.state.zero_()
        else:
            self.state.select(qubit - self.k, 1 - s).zero_()
        self.state.mul_(1.0 / np.sqrt(p))
        return s
