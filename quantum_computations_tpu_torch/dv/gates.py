"""Qubit gate classes (counterpart of ``quantum_computations_tpu/dv/gates.py``).

The same classes, ``.matrix`` (host numpy) and ``.indices`` and the same
index validation; ``apply`` works on a complex torch tensor through the
tensordot core in :mod:`.qop`, and measurement sampling draws from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import qop
from .states import State

REPR_DIGITS = 5


def _checked_indices(indices) -> list[int]:
    idx = [int(i) for i in indices]
    if any(i < 0 for i in idx):
        raise ValueError(f"gate indices must be non-negative, got {idx}")
    if len(set(idx)) != len(idx):
        raise ValueError(f"gate indices must be distinct, got {idx}")
    return idx


class Gate:
    def __init__(self, indices: list[int], matrix: np.ndarray | None):
        idx = _checked_indices(indices)
        if matrix is not None:
            matrix = np.asarray(matrix)
            if matrix.ndim != 2:
                raise ValueError(f"gate matrix must be 2-D, got ndim={matrix.ndim}")
            if not all(qop.is_power_of_two(s) for s in matrix.shape):
                raise ValueError(
                    f"gate matrix shape {matrix.shape} is not a map between "
                    "qubit registers (dimensions must be powers of two)")
            if matrix.shape[1] != 2 ** len(idx):
                raise ValueError(
                    f"gate matrix has {matrix.shape[1]} columns but acts on "
                    f"{len(idx)} qubit(s) (needs {2 ** len(idx)})")
        self.indices = idx
        self.matrix = matrix

    def __repr__(self):
        return f"{type(self).__name__}_" + ",".join(str(i) for i in self.indices)

    def copy(self) -> "Gate":
        import copy as _copy

        gate = _copy.copy(self)
        gate.indices = list(self.indices)
        return gate

    def relabel(self, mapping: dict):
        """Rewrite this gate's qubit indices through `mapping` (in place)."""
        try:
            self.indices = _checked_indices(mapping[i] for i in self.indices)
        except KeyError as exc:
            raise ValueError(f"index {exc.args[0]} missing from relabel mapping")

    def apply(self, state: torch.Tensor) -> torch.Tensor:
        if self.matrix is None:
            raise ValueError(f"{self} has no matrix representation to apply.")
        if state.ndim == 1:
            return qop.apply_unitary(state, self.matrix, tuple(self.indices))
        if state.ndim == 2:
            return qop.apply_unitary_dm(state, self.matrix, tuple(self.indices))
        raise ValueError(f"state must be a vector or density matrix, ndim={state.ndim}")


class SingleQubitGate(Gate):
    def __init__(self, index: int, matrix):
        super().__init__([index], matrix)


class TwoQubitGate(Gate):
    def __init__(self, index1: int, index2: int, matrix):
        super().__init__([index1, index2], matrix)


class I(SingleQubitGate):  # noqa: E742 — named for parity with the physics literature
    def __init__(self, index):
        super().__init__(index, qop.IDTY)


class X(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.X)


class Y(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.Y)


class Z(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.Z)


class H(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.H)


class RZ(SingleQubitGate):
    def __init__(self, index, angle: float):
        super().__init__(index, qop.axis_rotation(angle, [0, 0, 1]))
        self.angle = angle

    def __repr__(self):
        return super().__repr__() + f"({round(self.angle, REPR_DIGITS)})"


class P(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.axis_rotation(np.pi / 2, [0, 0, 1]))


class Pdg(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.axis_rotation(-np.pi / 2, [0, 0, 1]))


class T(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.axis_rotation(np.pi / 4, [0, 0, 1]))


class Tdg(SingleQubitGate):
    def __init__(self, index):
        super().__init__(index, qop.axis_rotation(-np.pi / 4, [0, 0, 1]))


class CX(TwoQubitGate):
    def __init__(self, control, target):
        super().__init__(control, target, qop.CX)

    @property
    def control(self):
        return self.indices[0]

    @property
    def target(self):
        return self.indices[1]


class CZ(TwoQubitGate):
    def __init__(self, index1, index2):
        super().__init__(index1, index2, qop.CZ)


class SWAP(TwoQubitGate):
    def __init__(self, index1, index2):
        super().__init__(index1, index2, qop.SWAP)


class Insert(SingleQubitGate):
    """Adds a fresh qubit in `state` at position `index`."""

    def __init__(self, index: int, state: State):
        super().__init__(index, np.asarray(state.get()).reshape((1, 2)))
        self.state = state

    def __repr__(self):
        return super().__repr__() + f"({self.state})"

    def apply(self, state: torch.Tensor) -> torch.Tensor:
        return qop.insert_qubit(state, self.matrix[0, :], self.indices[0])


class M(SingleQubitGate):
    """Projective measurement along the (theta, phi) axis.

    Sampling draws from an explicit ``torch.Generator`` (pass via
    ``apply(state, generator=...)``) so trajectories are reproducible.
    ``result`` post-selects deterministically.
    """

    def __init__(self, index: int, theta: float, phi: float, *, result: int | None = None):
        super().__init__(index, None)
        if result is not None and result not in [0, 1]:
            raise ValueError(
                f"Measurement results must be from 0 or 1 but {result} was given."
            )
        self.theta = theta
        self.phi = phi
        self.result = result
        rotation = qop.axis_rotation(phi, [0, 0, 1]) @ qop.axis_rotation(theta, [0, 1, 0])
        self._eigvecs = np.stack([rotation @ qop.ZERO, rotation @ qop.ONE])

    def apply(self, state: torch.Tensor,
              generator: torch.Generator | None = None):
        """(collapsed state, outcome): the state renormalised, outcome 0/1."""
        i = self.indices[0]
        e0, e1 = self._eigvecs
        p0 = qop.born_probability(state, i, e0)
        p1 = qop.born_probability(state, i, e1)
        if self.result is not None:
            s = self.result
        else:
            if generator is None:
                raise ValueError(
                    "Measurement requires a torch.Generator (pass generator=...).")
            u = torch.rand((), generator=generator, device=generator.device)
            s = int(u.item() < float(p1 / (p0 + p1)))
        proj = qop.project_qubit(state, i, (e0, e1)[s])
        return proj / torch.sqrt((p0, p1)[s]), s


class MZ(M):
    def __init__(self, index, *, result=None):
        super().__init__(index, 0.0, 0.0, result=result)


class MX(M):
    def __init__(self, index, *, result=None):
        super().__init__(index, np.pi / 2, 0.0, result=result)
