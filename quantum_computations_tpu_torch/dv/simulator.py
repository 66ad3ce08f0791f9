"""DV circuit engine of the port (counterpart of
``quantum_computations_tpu/dv/simulator.py``).

A sequential gate loop over a complex state vector with measurements and
classical feed-forward: ``ClassicalControl`` applies its gate iff the
results it names are set (positive indices) or clear (negative indices).
The JAX engine traces the whole circuit into one function of
``(state, key)`` and resolves the control with ``jnp.where``; here the
loop runs eagerly, measurement outcomes are host ints, and the control is
a host branch. Measurements draw from one ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype, resolve_device
from ..utils import as_generator
from . import qop
from .gates import Gate, Insert, M
from .states import State


class ClassicalControl:
    """Apply `gate` iff all positive-index results are 1 and negative are 0.

    Indices address the ``results`` list accumulated so far (negative
    Python indexing allowed).
    """

    def __init__(self, gate: Gate, positive_indices=(), negative_indices=()):
        self.gate = gate
        self.indices = gate.indices
        self._pos = list(positive_indices)
        self._neg = list(negative_indices)

    def __repr__(self):
        return f"Classical control: {self.gate}"

    def eval(self, observables: list) -> bool:
        return (all(int(observables[i]) != 0 for i in self._pos)
                and all(int(observables[i]) == 0 for i in self._neg))


def parse_state(state, device=None) -> torch.Tensor:
    """An initial state vector on ``device`` (default ``cuda``) in
    :func:`..config.complex_dtype` of it: None (the empty register), an
    array, or a list of :class:`.states.State`."""
    device = resolve_device(device)
    dtype = complex_dtype(device)
    if state is None:
        return torch.ones((1,), dtype=dtype, device=device)
    if isinstance(state, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(state).to(device=device, dtype=dtype)
    if isinstance(state, list) and all(isinstance(item, State) for item in state):
        return qop.tensor(*(s.get() for s in state)).to(device=device, dtype=dtype)
    raise TypeError("Unsupported input type")


class Simulator:
    """Sequential circuit simulator.

    ``run`` executes the circuit on ``device`` (default ``cuda``);
    measurement outcomes are stored in ``self.results`` as 0/1 ints. One
    seed gives the same outcomes on every run.
    """

    def __init__(self, circuit: list, rng_seed: int | None = None, *, device=None):
        self.circuit = circuit
        self.results: list[int] | None = None
        self.device = device
        self._seed = rng_seed if rng_seed is not None else np.random.SeedSequence().entropy % (2**31)

    def _validate(self, n_qubits: int):
        """Every gate addresses a qubit of the register as it stands then."""
        for gate in self.circuit:
            inner = gate.gate if isinstance(gate, ClassicalControl) else gate
            if isinstance(inner, Insert):
                if inner.indices[0] > n_qubits:
                    raise ValueError(
                        f"{inner} inserts past the end of the "
                        f"{n_qubits}-qubit register")
                n_qubits += 1
            else:
                bad = [i for i in inner.indices if i < 0 or i >= n_qubits]
                if bad:
                    raise ValueError(
                        f"{inner} addresses qubit(s) {bad} outside the "
                        f"{n_qubits}-qubit register")

    def _execute(self, state: torch.Tensor, generator: torch.Generator):
        self._validate(qop.num_qubits(state))
        results = []
        for gate in self.circuit:
            if isinstance(gate, ClassicalControl):
                inner = gate.gate
                if inner.matrix is None:
                    raise ValueError("ClassicalControl over non-unitary gates is not supported.")
                if gate.eval(results):
                    state = qop.apply_unitary(state, inner.matrix, tuple(inner.indices))
            elif isinstance(gate, M):
                state, s = gate.apply(state, generator=generator)
                results.append(s)
            else:
                state = gate.apply(state)
        return state, results

    def as_fn(self):
        """The plain function ``(initial_state, generator) -> (final_state,
        results)``, results a list of 0/1 ints."""
        return self._execute

    def run(self, initial_state=None) -> torch.Tensor:
        state = parse_state(initial_state, self.device)
        state, self.results = self._execute(state, as_generator(self._seed))
        return state
