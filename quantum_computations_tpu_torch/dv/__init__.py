"""Qubit state-vector engine of the port (counterpart of
``quantum_computations_tpu/dv``): gates and named states, window fusion,
the sequential :class:`Simulator` with measurements and classical control,
and the large-N split-real :class:`FastStatevector` (slab, window and
chain modes)."""

from . import fusion, qop
from .states import State
from .gates import (
    Gate, I, X, Y, Z, H, RZ, P, Pdg, T, Tdg, CX, CZ, SWAP, Insert, M, MZ, MX,
)
from .simulator import Simulator, ClassicalControl, parse_state
from .fast_sv import FastStatevector

__all__ = [
    "fusion", "qop", "State", "Gate", "I", "X", "Y", "Z", "H", "RZ", "P",
    "Pdg", "T", "Tdg", "CX", "CZ", "SWAP", "Insert", "M", "MZ", "MX",
    "Simulator", "ClassicalControl", "parse_state", "FastStatevector",
]
