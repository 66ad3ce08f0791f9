"""Measurement-based GKP circuit engine, eager (counterpart of
``quantum_computations_tpu/gkp/simulator.py``).

Each DV gate of an :class:`.transpiler.MBGKPCircuit` is transpiled to its
MB gadget, whose CV gates run in a nested :class:`..cv.Simulator` on the
engine's state; the gadget's homodyne outcomes decode to a syndrome on the
host. A Pauli frame is carried through the circuit by a rule table (the
symplectic action of each Clifford on (x, z) bits; T/Tdg consult it to
flip their dagger), and a two-layer window of syndromes feeds the
classically controlled T correction. Every gadget draws from the engine's
one host ``torch.Generator``, so a seed gives the same outcomes on every
run and device. Log messages are formatted only when their level is on.
"""

from __future__ import annotations

import logging
from collections import deque
from collections.abc import Callable
from timeit import default_timer as timer

from ..config import SVDOptions
from ..cv.gate_abc import MeasurementResult
from ..cv.gates import F as FourierGate
from ..cv.mps import MPS
from ..cv.simulator import Simulator as CVSimulator, format_time
from ..dv import gates as dv_gates
from ..dv.gates import Gate as DVGate
from ..utils import annotate, as_generator
from .gates import MeasurementBased, Syndrome
from .transpiler import ClassicalControl, MBGKPCircuit, gate_transpile
from .utils import format_result

logger = logging.getLogger(__name__)


def measurement_formatter(result: MeasurementResult) -> str:
    return format_result(result.result)


# Frame-update rules: how conjugation by each Clifford transforms one
# (x, z) syndrome pair, or for two-qubit gates a pair of pairs.
def _frame_h(p):
    return (p[1], p[0])


def _frame_p(p):
    return (p[0], p[1] ^ p[0])


def _frame_cz(p1, p2):
    return (p1[0], p1[1] ^ p2[0]), (p2[0], p2[1] ^ p1[0])


def _frame_swap(p1, p2):
    return p2, p1


_SINGLE_RULES = {dv_gates.H: _frame_h, dv_gates.P: _frame_p, dv_gates.Pdg: _frame_p}
_PAIR_RULES = {dv_gates.CZ: _frame_cz, dv_gates.SWAP: _frame_swap}
_T_FLIP = {dv_gates.T: dv_gates.Tdg, dv_gates.Tdg: dv_gates.T}


def commute(gate: DVGate, paulis: list[Syndrome]) -> tuple[list[Syndrome], DVGate]:
    """Commute `gate` through `paulis` such that gate * paulis = paulis' * gate'."""
    frame = list(paulis)
    t = type(gate)
    if t in _T_FLIP:
        # an X in front of T conjugates it to Tdg (up to the tracked frame)
        if frame[gate.indices[0]][0]:
            gate = _T_FLIP[t](*gate.indices)
    elif t in _SINGLE_RULES:
        i = gate.indices[0]
        frame[i] = _SINGLE_RULES[t](frame[i])
    elif t in _PAIR_RULES:
        i, j = gate.indices
        frame[i], frame[j] = _PAIR_RULES[t](frame[i], frame[j])
    elif t is not dv_gates.I:
        raise NotImplementedError(f"Commutator logic for gate: {gate} not implemented.")
    return frame, gate


def _xor_into(target: list[Syndrome], updates) -> None:
    for i, (x, z) in enumerate(updates):
        tx, tz = target[i]
        target[i] = (tx ^ x, tz ^ z)


class Simulator(CVSimulator):
    """Runs an :class:`MBGKPCircuit` by expanding each DV gate into its MB
    gadget and executing the compiled CV gates with a nested CV engine.

    ``run(mps)`` returns (final MPS, Pauli syndrome per qubit). The state's
    device and dtype are the initial MPS's (see
    :func:`.transpiler.parse_to_mps`).
    """

    def __init__(
        self,
        circuit: MBGKPCircuit,
        ancilla_epsilon: float,
        *,
        rng_seed=None,
        svd_options: SVDOptions | dict | None = None,
        debug_info: Callable | None = None,
    ):
        self._circuit = circuit
        self._N = circuit._N
        self.generator = as_generator(rng_seed)
        self._epsilon = ancilla_epsilon
        self._state: MPS | None = None
        self.pauli_syndrome: list[Syndrome] | None = None
        if isinstance(svd_options, dict):
            svd_options = SVDOptions(**svd_options)
        self._svd_options = svd_options or SVDOptions()
        self.debug_info = debug_info or (lambda _: None)

    def apply_gate(self, dv_gate: DVGate) -> tuple[list[Syndrome], list[int]]:
        """Transpile one DV gate to its MB gadget, run the compiled CV gate
        list in a nested CV engine, and decode the gadget syndrome."""
        gadget: MeasurementBased = gate_transpile(dv_gate, epsilon=self._epsilon)
        nested = CVSimulator(
            gadget.compile(), rng_seed=self.generator,
            measurement_formatter=measurement_formatter,
            svd_options=self._svd_options,
        )
        with annotate(f"gkp:{type(gadget).__name__}"):
            self._state = nested.run(self._state)
        return gadget.compute_syndrome([r.result for r in nested.results])

    def _resolve_control(self, gate, window) -> DVGate:
        """The classically controlled T correction fires iff the X syndrome
        of the same qubit two layers back is set."""
        if not isinstance(gate, ClassicalControl):
            return gate
        qubit = gate.indices[0]
        return gate.gate if int(window[0][qubit][0]) else dv_gates.I(qubit)

    def run(self, initial_state: MPS) -> tuple[MPS, list[Syndrome]]:
        initial_state.validate()
        self._state = initial_state
        self.pauli_syndrome = [(0, 0)] * self._N
        # two-layer sliding window of per-qubit gadget syndromes
        window = deque([[(0, 0)] * self._N] * 2, maxlen=2)
        info = logger.isEnabledFor(logging.INFO)

        circ_start = timer()
        layers = self._circuit._layers
        if info:
            logger.info(f"Total number of MB gates: {self._circuit.count()} "
                        f"in a total of {len(layers)} layers.")
        for li, layer in enumerate(layers):
            if info:
                logger.info(f"Layer {li+1} of {len(layers)}.")
            window.append([(0, 0)] * self._N)
            for gate in layer.gates:
                gate = self._resolve_control(gate, window)
                self.pauli_syndrome, gate = commute(gate, self.pauli_syndrome)
                if info:
                    logger.info(f"MB gate: {gate}")
                syndromes, indices = self.apply_gate(gate)
                for i, (x, z) in zip(indices, syndromes, strict=True):
                    window[-1][i] = (int(x), int(z))
                if info:
                    logger.info(f"Gate syndrome: {[window[-1][i] for i in indices]}")

            _xor_into(self.pauli_syndrome, window[-1])
            _xor_into(self.pauli_syndrome, layer.paulis)
            if info:
                logger.info(f"Syndrome correction: {window[-1]}; Pauli operators: "
                            f"{layer.paulis}; Pauli syndrome: {self.pauli_syndrome}")
            if logger.isEnabledFor(logging.DEBUG):
                self.debug_info(self)

        if info:
            logger.info("Finished MB GKP simulation! Total time: "
                        + format_time(timer() - circ_start))
        return self._state, [tuple(s) for s in self.pauli_syndrome]

    def apply_paulis(self, paulis: list[Syndrome]):
        _xor_into(self.pauli_syndrome, paulis)


class SimulatorAlt(Simulator):
    """Variant applying H as an exact Fourier with no error correction."""

    def apply_gate(self, dv_gate) -> tuple[list[Syndrome], list[int]]:
        t = type(dv_gate)
        if t is dv_gates.I:
            return [(0, 0)], dv_gate.indices
        if t is dv_gates.H:
            FourierGate(dv_gate.indices[0]).apply(self._state)
            return [(0, 0)], dv_gate.indices
        return super().apply_gate(dv_gate)
