"""DV -> measurement-based GKP transpiler (counterpart of
``quantum_computations_tpu/gkp/transpiler.py``).

The implementable gate set, state transpilation, gate -> gadget mapping
with dagger folding, and ``MBGKPCircuit``: as-soon-as-possible layering
(each qubit carries its next free layer), Paulis folded into a per-layer
virtual frame, and a classically controlled P/Pdg correction scheduled
after every T/Tdg. The GKP engine's T correction reads the syndromes of
exactly two layers back, so the schedule is load-bearing. Host Python.
"""

from __future__ import annotations

from bisect import insort

import numpy as np

from ..config import resolve_device
from ..cv.mps import MPS
from ..cv.states import State as CVState
from ..dv import gates as dv_gates
from ..dv.gates import Gate as DVGate
from ..dv.simulator import ClassicalControl
from ..dv.states import State as DVState
from .gates import MBCZ, MBF, MBI, MBP, MBSWAP, MBT, MeasurementBased

IMPLEMENTABLES = (
    dv_gates.I, dv_gates.H, dv_gates.P, dv_gates.Pdg,
    dv_gates.T, dv_gates.Tdg, dv_gates.CZ, dv_gates.SWAP,
)
PAULIS = (dv_gates.I, dv_gates.X, dv_gates.Y, dv_gates.Z)

_STATE_MAP = {
    DVState.ZERO: CVState.GKP_ZERO,
    DVState.ONE: CVState.GKP_ONE,
    DVState.PLUS: CVState.GKP_PLUS,
    DVState.MINUS: CVState.GKP_MINUS,
    DVState.T: CVState.GKP_T,
    DVState.TDG: CVState.GKP_TDG,
    DVState.H: CVState.GKP_H,
}

_GADGET_MAP = {
    dv_gates.I: MBI,
    dv_gates.H: MBF,
    dv_gates.P: MBP,
    dv_gates.Pdg: MBP,
    dv_gates.T: MBT,
    dv_gates.Tdg: MBT,
    dv_gates.CZ: MBCZ,
    dv_gates.SWAP: MBSWAP,
}

_PAULI_FRAME = {
    dv_gates.X: (1, 0),
    dv_gates.Y: (1, 1),
    dv_gates.Z: (0, 1),
}


def state_transpile(state: DVState) -> CVState:
    return _STATE_MAP[state]


def parse_to_mps(state, epsilon: float, qs: np.ndarray, *, device=None,
                 dtype=None) -> MPS:
    """The GKP encoding of ``state`` (None, an MPS, or a list of DV
    states) as an MPS on the grid ``qs``, on ``device`` (default ``cuda``)
    in ``dtype`` (default the device's complex dtype)."""
    if isinstance(state, MPS):
        return state
    device = resolve_device(device)
    if state is None:
        return MPS(qs, [], device=device, dtype=dtype)
    if isinstance(state, list) and all(isinstance(item, DVState) for item in state):
        return MPS(qs, [state_transpile(s).eval(qs, epsilon, device=device, dtype=dtype)
                        for s in state], device=device, dtype=dtype)
    raise TypeError("Unsupported input type")


def gate_transpile(gate: DVGate, **kwargs) -> MeasurementBased:
    """DV gate -> MB gadget; Pdg/Tdg fold into the dagger flag."""
    dagger = (type(gate) in (dv_gates.Pdg, dv_gates.Tdg)) ^ kwargs.pop("dagger", False)
    gadget = _GADGET_MAP.get(type(gate))
    if gadget is None:
        raise ValueError(f"Gate {gate} not implementable in MB GKP circuits.")
    return gadget(*gate.indices, dagger=dagger, **kwargs)


class Layer:
    """One depth slice: scheduled gates + the layer's virtual Pauli frame."""

    def __init__(self, N: int):
        self._N = N
        self._occupied = [False] * N
        self.gates: list[DVGate | ClassicalControl] = []
        self.paulis: list[list[int]] = [[0, 0] for _ in range(N)]

    def copy(self) -> "Layer":
        result = Layer(self._N)
        result.gates = self.gates.copy()
        result.paulis = self.paulis.copy()
        return result

    def get_gate(self, index: int):
        for gate in self.gates:
            if index in gate.indices:
                return gate
        return None

    def occupied(self, indices) -> bool:
        return any(self._occupied[i] or self.paulis[i] != [0, 0] for i in indices)

    def fill(self):
        """Schedule identity (= error-correction) gadgets on idle qubits."""
        for i in range(self._N):
            if not self.get_gate(i):
                self._insert(dv_gates.I(i))

    def add_gate(self, gate) -> bool:
        if self.occupied(gate.indices):
            return False
        self._insert(gate)
        return True

    def _insert(self, gate):
        for i in gate.indices:
            self._occupied[i] = True
        insort(self.gates, gate, key=lambda g: min(g.indices))

    def add_pauli(self, index: int, pauli):
        self.paulis[index][0] = (self.paulis[index][0] + pauli[0]) % 2
        self.paulis[index][1] = (self.paulis[index][1] + pauli[1]) % 2


class MBGKPCircuit:
    """Depth-layered MB circuit with a virtual Pauli frame per layer."""

    def __init__(self, N: int):
        self._N = N
        self._layers: list[Layer] = [Layer(N)]
        # first layer index with a free slot, per qubit
        self._next_free = [0] * N

    def depth(self) -> int:
        return len(self._layers)

    def count(self) -> int:
        return sum(len(layer.gates) for layer in self._layers)

    def to_string(self) -> str:
        rows = []
        for q in range(self._N):
            cells = []
            for layer in self._layers:
                gate = layer.get_gate(q)
                label = f"'{gate.gate}'" if isinstance(gate, ClassicalControl) else str(gate)
                cells.append(label.ljust(8) + " " + str(layer.paulis[q]))
            rows.append(" | ".join(cells))
        return "\n".join(rows)

    @staticmethod
    def transpile(gates: list[DVGate], N: int | None = None) -> "MBGKPCircuit":
        if N is None:
            N = max(max(gate.indices) for gate in gates) + 1
        circ = MBGKPCircuit(N)
        for gate in gates:
            circ.add_gate(gate)
        return circ

    def fill(self):
        for layer in self._layers:
            layer.fill()
        self._next_free = [len(self._layers)] * self._N

    def _validate(self, gate):
        if any(i < 0 or i >= self._N for i in gate.indices):
            raise ValueError(f"Cannot add {gate} to MBGKPCircuit with {self._N} qubits.")
        if len(gate.indices) > 2:
            raise ValueError(
                f"Only single- and two-mode gates available, but gate {gate} was given."
            )
        if len(gate.indices) == 2 and abs(gate.indices[0] - gate.indices[1]) != 1:
            raise ValueError(
                f"Only nearest neighbour interactions available, but gate {gate} was given."
            )

    def add_gate(self, gate: DVGate):
        self._validate(gate)
        if type(gate) in PAULIS and not isinstance(gate, dv_gates.I):
            self._schedule_pauli(gate)
        elif type(gate) in IMPLEMENTABLES:
            self._schedule(gate)
            # the MB T teleportation needs a classically controlled P in
            # the next layer; the engine reads the X syndrome two layers
            # back at run time
            if isinstance(gate, dv_gates.T):
                self._schedule(ClassicalControl(dv_gates.P(gate.indices[0]), [-self._N]))
            elif isinstance(gate, dv_gates.Tdg):
                self._schedule(ClassicalControl(dv_gates.Pdg(gate.indices[0]), [-self._N]))
        else:
            raise ValueError(f"Gate {gate} not implementable in MB GKP circuits.")

    def _schedule(self, gate):
        """The earliest layer where every operand slot is free."""
        layer_idx = max(self._next_free[i] for i in gate.indices)
        while layer_idx >= len(self._layers):
            self._layers.append(Layer(self._N))
        self._layers[layer_idx].add_gate(gate)
        for i in gate.indices:
            self._next_free[i] = layer_idx + 1

    def _schedule_pauli(self, gate: DVGate):
        """A Pauli folds into the frame of its qubit's last occupied layer
        (the first layer if untouched), which then counts as occupied; two
        Paulis that cancel on an otherwise free slot free it again."""
        q = gate.indices[0]
        layer_idx = max(self._next_free[q] - 1, 0)
        layer = self._layers[layer_idx]
        layer.add_pauli(q, _PAULI_FRAME[type(gate)])
        if layer.paulis[q] == [0, 0] and not layer._occupied[q]:
            self._next_free[q] = layer_idx
        else:
            self._next_free[q] = layer_idx + 1
