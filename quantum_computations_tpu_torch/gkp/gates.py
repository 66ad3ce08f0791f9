"""Measurement-based GKP gate gadgets (counterpart of
``quantum_computations_tpu/gkp/gates.py``).

Homodyne-angle tables, the ``MeasurementBased`` base with ``compile`` /
``compute_syndrome``, the Walshe-style single-mode teleportation gadget,
the macronode two-mode gadget, and the concrete gates
MBI/MBF/MBP/MBSWAP/MBCZ/MBT. ``results=`` forces the gadget's homodyne
outcomes. Syndromes are decoded on the host from host floats (the port's
outcomes are host floats), so decoding never waits for the device.
"""

from __future__ import annotations

import cmath
import logging
import math
from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np

from ..config import SVDOptions
from ..cv.gate_abc import Gate
from ..cv.gates import BS, Homodyne
from .bell import GKPBellState, InsertBell

logger = logging.getLogger(__name__)

PI = np.pi
SQPI = np.sqrt(np.pi)

Syndrome = tuple  # (x, z) bits


class MBType(Enum):
    I = auto()  # noqa: E741
    F = auto()
    P = auto()

    def angles(self):
        match self:
            case MBType.I:
                return [0.0, PI / 2]
            case MBType.F:
                return [PI / 4, -PI / 4]
            case MBType.P:
                return [0.0, float(np.arctan(2))]


class MB2Type(Enum):
    II = auto()
    FF = auto()
    PP = auto()
    PPdg = auto()
    CZ = auto()
    SWAP = auto()

    def angles(self):
        a2 = float(np.arctan(2))
        match self:
            case MB2Type.II:
                return [0.0, 0.0, PI / 2, PI / 2]
            case MB2Type.FF:
                return [PI / 4, PI / 4, -PI / 4, -PI / 4]
            case MB2Type.PP:
                return [0.0, 0.0, a2, a2]
            case MB2Type.PPdg:
                return [0.0, 0.0, a2, -a2]
            case MB2Type.CZ:
                return [0.0, 0.0, a2, -a2]
            case MB2Type.SWAP:
                return [-PI / 2, 0.0, 0.0, -PI / 2]


class MeasurementBased(ABC):
    """Abstract base class for MB GKP gates."""

    def __init__(self, indices: list[int], type: MBType | MB2Type, epsilon=None, *,
                 dagger: bool = False, svd_options: SVDOptions | None = None, **kwargs):
        self.indices = indices
        self.epsilon = epsilon
        self.type = type
        self.dagger = dagger
        fields = {k: kwargs.pop(k) for k in ("max_bond_dim", "abs_err", "rel_err") if k in kwargs}
        self.svd_options = svd_options if svd_options is not None else (
            SVDOptions(**fields) if fields else None
        )
        if kwargs:
            logger.warning(
                f"{type(self).__name__} received unexpected keyword arguments: {kwargs.keys()}"
            )

    def __repr__(self):
        return f"{type(self).__name__}_{','.join(map(str, self.indices))}"

    def angles(self) -> np.ndarray:
        return np.array(self.type.angles()) * (-1) ** self.dagger

    def _gate_kwargs(self) -> dict:
        return {"svd_options": self.svd_options} if self.svd_options else {}

    @abstractmethod
    def compile(self) -> list[Gate]:
        """Compile into a sequence of executable CV gates."""

    @abstractmethod
    def compute_syndrome(self, results: list) -> tuple[list[Syndrome], list[int]]:
        """(syndromes, mode indices) from homodyne results, ordered as
        produced by the measurements in :meth:`compile`."""


def _mu(ta, tb, ma, mb) -> complex:
    """The teleportation byproduct displacement
    mu = i (ma e^{i tb} + mb e^{i ta}) / sin(ta - tb)."""
    return 1j * (float(ma) * cmath.exp(1j * tb) + float(mb) * cmath.exp(1j * ta)) / math.sin(ta - tb)


def _parity_bits(mu: complex, scale: float = 1.0) -> Syndrome:
    """round((Re, Im) * scale / sqrt(pi)) mod 2, rounding half to even."""
    vec = np.array([mu.real, mu.imag]) * scale
    s = np.round(vec / SQPI).astype(np.int64) % 2
    return (int(s[0]), int(s[1]))


def _byproduct_syndrome(ta, tb, ma, mb) -> Syndrome:
    """Logical syndrome of the byproduct displacement: the quadrature
    vector of mu scaled by sqrt(2), in units of sqrt(pi), mod 2."""
    return _parity_bits(_mu(ta, tb, ma, mb), 2**0.5)


class MBSingleMode(MeasurementBased):
    """Error-corrected single-mode Gaussian gadget (Walshe et al.,
    PhysRevA.102.062411): Bell insertion + BS + two homodynes."""

    def __init__(self, index: int, type: MBType, epsilon=None, *,
                 results=None, **kwargs):
        super().__init__([index], type, epsilon, **kwargs)
        self.results = results if results is not None else (None, None)
        if len(self.results) != 2:
            raise ValueError("Results list must have exactly 2 elements.")

    def bell_state(self) -> GKPBellState:
        return GKPBellState.PLUS

    def _angles_compiled(self):
        return self.angles()

    def compile(self):
        idx = self.indices[0]
        angles = self._angles_compiled()
        kw = self._gate_kwargs()
        return [
            InsertBell(idx + 1, self.bell_state(), gkp_epsilon=self.epsilon, **kw),
            BS(idx, idx + 1, **kw),
            Homodyne(idx, angles[0], result=self.results[0]),
            Homodyne(idx, angles[1], result=self.results[1]),
        ]

    def compute_syndrome(self, results: list) -> tuple[list[Syndrome], list[int]]:
        """Syndrome (n, m), to be fixed by X(n sqrt(pi)) Z(m sqrt(pi))."""
        if len(results) != 2:
            raise ValueError("Exactly two measurement results are needed.")
        ta, tb = self.angles()
        ma, mb = results
        return [_byproduct_syndrome(ta, tb, ma, mb)], self.indices


class MBTwoMode(MeasurementBased):
    """Error-corrected two-mode Gaussian gadget (Walshe et al.,
    arXiv:2109.04668 macronode cluster): 2 Bell pairs + 3 BS + 4 homodynes.

    Angles and results are ordered [a, c, b, d] as in the paper; `a` is the
    measurement on the left-most input index.
    """

    def __init__(self, index1: int, index2: int, type: MB2Type, epsilon=None, *,
                 results=None, **kwargs):
        if abs(index1 - index2) != 1:
            raise ValueError(
                f"{type!r} two-mode gadgets apply to neighbours, got {(index1, index2)}."
            )
        results = results if results is not None else (None, None, None, None)
        if len(results) != 4:
            raise ValueError("Results list must have exactly 4 elements.")
        super().__init__(sorted([index1, index2]), type, epsilon, **kwargs)
        self.results = results

    def compile(self):
        idx = min(self.indices)
        ta, tc, tb, td = self.angles()
        ma, mc, mb, md = self.results
        kw = self._gate_kwargs()
        return [
            InsertBell(idx, gkp_epsilon=self.epsilon, **kw),
            InsertBell(idx + 4, gkp_epsilon=self.epsilon, **kw),
            BS(idx + 2, idx + 1, **kw),
            BS(idx + 3, idx + 4, **kw),
            BS(idx + 2, idx + 3, **kw),
            Homodyne(idx + 2, ta, result=ma),
            Homodyne(idx + 2, tc, result=mc),
            BS(idx + 1, idx + 2, **kw),
            Homodyne(idx + 1, tb, result=mb),
            Homodyne(idx + 1, td, result=md),
        ]

    def compute_syndrome(self, results: list) -> tuple[list[Syndrome], list[int]]:
        if len(results) != 4:
            raise ValueError("Exactly four measurement results are needed.")
        ta, tc, tb, td = self.angles()
        ma, mc, mb, md = results
        mu_ab = _mu(ta, tb, ma, mb)
        mu_cd = _mu(tc, td, mc, md)
        # the constant 1/sqrt(2) cancels against the sqrt(2) quadrature scaling
        return [_parity_bits(mu_cd + mu_ab), _parity_bits(mu_cd - mu_ab)], self.indices


class MBI(MBSingleMode):
    """Error correction using the Knill method."""

    def __init__(self, index, epsilon=None, *, results=None, **kwargs):
        super().__init__(index, MBType.I, epsilon=epsilon, results=results, **kwargs)


GKPEC = MBI


class MBF(MBSingleMode):
    """Error-corrected Fourier gate."""

    def __init__(self, index, epsilon=None, *, results=None, **kwargs):
        super().__init__(index, MBType.F, epsilon=epsilon, results=results, **kwargs)


class MBP(MBSingleMode):
    """Error-corrected P gate."""

    def __init__(self, index, epsilon=None, *, results=None, **kwargs):
        super().__init__(index, MBType.P, epsilon=epsilon, results=results, **kwargs)


class MBSWAP(MBTwoMode):
    """Error-corrected SWAP gate."""

    def __init__(self, index1, index2, epsilon=None, *, results=None, **kwargs):
        super().__init__(index1, index2, MB2Type.SWAP, epsilon=epsilon, results=results, **kwargs)


class MBCZ(MBTwoMode):
    """Error-corrected controlled-Z gate."""

    def __init__(self, index1, index2, epsilon=None, *, results=None, **kwargs):
        super().__init__(index1, index2, MB2Type.CZ, epsilon=epsilon, results=results, **kwargs)


class MBT(MBSingleMode):
    """Non-Clifford T gate via a magic GKP Bell state; it measures with
    the identity gadget's angles whatever its dagger."""

    def __init__(self, index, epsilon=None, *, results=None, **kwargs):
        super().__init__(index, MBType.I, epsilon=epsilon, results=results, **kwargs)

    def bell_state(self) -> GKPBellState:
        return GKPBellState.T if not self.dagger else GKPBellState.Tdg

    def _angles_compiled(self):
        return MBType.I.angles()
