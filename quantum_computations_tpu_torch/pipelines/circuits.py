"""DV circuit builders (counterpart of
``quantum_computations_tpu/pipelines/circuits.py``, a copy on the port's
:mod:`..dv.gates`): ``relabel``, the nearest-neighbour ``CCZ``
decomposition, the 3-qubit Grover builder and the tagged-pair oracles.
"""

from __future__ import annotations

from ..dv.gates import CX, CZ, Gate, H, Insert, SWAP, T, Tdg, X, Z
from ..dv.states import State


def relabel(circuit: list[Gate], mapping: dict) -> list[Gate]:
    """Non-intrusively map qubit indices i -> mapping.get(i, i)."""
    indices = set().union(*[gate.indices for gate in circuit])
    full_map = {i: i for i in indices}
    full_map.update(mapping)
    if len(full_map) != len(set(full_map.values())):
        raise ValueError("Generated mapping is not injective.")
    result = []
    for gate in circuit:
        g = gate.copy()
        g.relabel(full_map)
        result.append(g)
    return result


def ccz() -> list[Gate]:
    """Nearest-neighbour CCZ decomposition over qubits (0, 1, 2).

    Guaranteed nearest-neighbour if qubit 1 neighbours both 0 and 2.
    """
    return [
        CX(2, 1), Tdg(1), CX(0, 1), T(1),
        CX(2, 1), Tdg(1), CX(0, 1), T(1),
        T(2),
        SWAP(1, 2),
        CX(0, 1), T(0), Tdg(1), CX(0, 1),
        SWAP(1, 2),
    ]


# A module-level list as in the JAX package; ccz() returns fresh gates.
CCZ = ccz()


def grover(oracle_gates: list[Gate]) -> list[Gate]:
    """One 3-qubit Grover iteration: prepare |+++>, oracle, diffusion."""
    hs = lambda: [H(0), H(1), H(2)]  # noqa: E731
    xs = lambda: [X(0), X(1), X(2)]  # noqa: E731
    return [
        Insert(0, State.ZERO),
        Insert(1, State.ZERO),
        Insert(2, State.ZERO),
        *hs(),
        *oracle_gates,
        *hs(),
        *xs(),
        *ccz(),
        *xs(),
        *hs(),
    ]


def int2tag(n: int, N: int = 0) -> str:
    return "{0:0{1}b}".format(n, N)


def tag2int(tag: str) -> int:
    return int(tag, 2)


def oracle(tagged: list[int]) -> list[Gate]:
    """Phase oracles tagging the given pair of basis states (CZ/Z only)."""
    match sorted(tagged):
        case [3, 6]:
            return [CZ(0, 1), CZ(1, 2)]
        case [0, 4]:
            return [Z(1), Z(2), CZ(1, 2)]
        case [2, 7]:
            return [Z(1), CZ(0, 1), CZ(1, 2)]
        case _:
            raise NotImplementedError("Requested oracle not implemented")
