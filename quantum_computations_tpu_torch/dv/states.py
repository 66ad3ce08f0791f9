"""Single-qubit named states (counterpart of
``quantum_computations_tpu/dv/states.py``)."""

from __future__ import annotations

from enum import Enum, auto

import numpy as np

from . import qop


class State(Enum):
    ZERO = auto()
    ONE = auto()
    PLUS = auto()
    MINUS = auto()
    T = auto()
    TDG = auto()
    H = auto()

    def __repr__(self):
        return self.name

    def get(self) -> np.ndarray:
        match self:
            case State.ZERO:
                return qop.ZERO
            case State.ONE:
                return qop.ONE
            case State.PLUS:
                return qop.PLUS
            case State.MINUS:
                return qop.MINUS
            case State.T:
                return np.array([1.0, np.exp(1.0j * np.pi / 4.0)]) * 2**-0.5
            case State.TDG:
                return np.array([1.0, np.exp(-1.0j * np.pi / 4.0)]) * 2**-0.5
            case State.H:
                return np.array([np.cos(np.pi / 8.0), np.sin(np.pi / 8.0)])
