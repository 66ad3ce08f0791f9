"""Circuits of the benchmark's traffic, as DV gate lists ``[(name, indices)]``.

:func:`random_clifford` is a frozen copy of ``random_circ`` in
``quantum_computations_tpu_torch/pipelines/rb.py`` at commit 6cc9e90: gates
drawn from {I, H, P, Pdg, CZ, SWAP} with the same numpy calls, so one
generator state draws the same circuit, until the measurement-based
circuit reaches the depth (its layering is the reference's copy of the
port's transpiler). :func:`grover` is the CZ-only three-qubit Grover
iteration of ``pipelines/grover.grover`` and ``pipelines/circuits`` at the
same commit (a CX becomes H CZ H on its target).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference.engine import transpile

GATE_NAMES = ("I", "H", "P", "Pdg", "CZ", "SWAP")
_SINGLE = {"I", "H", "P", "Pdg"}

# phase oracles tagging a pair of basis states (pipelines/circuits.oracle)
_ORACLES = {
    (3, 6): [("CZ", (0, 1)), ("CZ", (1, 2))],
    (0, 4): [("Z", (1,)), ("Z", (2,)), ("CZ", (1, 2))],
    (2, 7): [("Z", (1,)), ("CZ", (0, 1)), ("CZ", (1, 2))],
}

# nearest-neighbour CCZ over (0, 1, 2): ("CX", (control, target))
_CCZ = [
    ("CX", (2, 1)), ("Tdg", (1,)), ("CX", (0, 1)), ("T", (1,)),
    ("CX", (2, 1)), ("Tdg", (1,)), ("CX", (0, 1)), ("T", (1,)),
    ("T", (2,)), ("SWAP", (1, 2)),
    ("CX", (0, 1)), ("T", (0,)), ("Tdg", (1,)), ("CX", (0, 1)),
    ("SWAP", (1, 2)),
]


def random_clifford(N: int, depth: int, rng: np.random.Generator) -> list[tuple]:
    """Random gates until the transpiled circuit has ``depth`` layers."""
    if N < 2:
        raise ValueError("At least 2 qubits required!")
    names = np.empty(len(GATE_NAMES), dtype=object)
    names[:] = GATE_NAMES
    gates: list[tuple] = []
    while len(transpile(gates, N)) < depth:
        name = rng.choice(names, 1)[0]
        if name in _SINGLE:
            gates.append((name, (int(rng.choice(range(N), 1)[0]),)))
        else:
            i = int(rng.choice(range(N - 1), 1)[0])
            gates.append((name, (i, i + 1)))
    return gates


def grover(tagged) -> list[tuple]:
    """The three-qubit Grover iteration for a tagged pair, from |000>."""
    hs = [("H", (i,)) for i in range(3)]
    xs = [("X", (i,)) for i in range(3)]
    gates = hs + _ORACLES[tuple(sorted(tagged))] + hs + xs + _CCZ + xs + hs
    out = []
    for name, idx in gates:
        if name == "CX":
            control, target = idx
            out += [("H", (target,)), ("CZ", (control, target)), ("H", (target,))]
        else:
            out.append((name, idx))
    return out
