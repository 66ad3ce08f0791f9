"""CV gate base classes (counterpart of
``quantum_computations_tpu/cv/gate_abc.py``).

``Gate`` with ``arg``/``dagger``/svd-options cascade, ``SingleModeGate``,
``Measurement`` returning :class:`MeasurementResult`, and the
nearest-neighbour-enforcing ``TwoModeGate``. Stochastic gates draw from an
explicit ``torch.Generator`` passed to ``apply``.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any

from ..config import SVDOptions
from .mps import MPS

logger = logging.getLogger(__name__)

REPR_DIGITS = 5


class MeasurementResult:
    """A measurement's outcome ``result`` (a host float) and its
    ``probability`` density (a 0-d tensor on the state's device)."""

    def __init__(self, result, probability):
        self.result = result
        self.probability = probability

    def __repr__(self):
        return str(self.result)


class Gate(ABC):
    """Abstract base class for CV quantum gates."""

    def __init__(self, arg: Any = None, dagger: bool = False,
                 svd_options: SVDOptions | None = None, **kwargs):
        self.arg = arg
        self.dagger = dagger
        # Loose kwargs for the truncation fields (max_bond_dim / abs_err /
        # rel_err), as the reference takes them.
        fields = {k: kwargs.pop(k) for k in ("max_bond_dim", "abs_err", "rel_err") if k in kwargs}
        if fields and svd_options is not None:
            raise ValueError("Pass either svd_options or loose truncation kwargs, not both.")
        self.svd_options = svd_options if svd_options is not None else (
            SVDOptions(**fields) if fields else None
        )
        if kwargs:
            logger.warning(
                f"{type(self).__name__} received unexpected keyword arguments: {kwargs.keys()}"
            )

    def __repr__(self):
        arg = self.arg
        arg = round(arg, REPR_DIGITS) if isinstance(arg, float) else arg
        return (
            type(self).__name__
            + (f"({arg})" if arg is not None else "")
            + ("^†" if self.dagger else "")
        )

    def effective_svd_options(self, base: SVDOptions | None) -> SVDOptions:
        """Simulator-wide options merged under gate-level overrides."""
        base = base if base is not None else SVDOptions()
        return base.merged_into(self.svd_options)

    @abstractmethod
    def apply(self, mps: MPS, **kwargs) -> "None | MeasurementResult":
        """Apply to `mps` in place; measurements return a MeasurementResult.

        kwargs: ``generator`` — ``torch.Generator`` for stochastic gates
        (sampling and randomized SVD sketches); ``svd_options`` —
        simulator-wide truncation defaults.
        """


class SingleModeGate(Gate):
    def __init__(self, index: int, **kwargs):
        kwargs.pop("dagger_ignored", None)
        super().__init__(**kwargs)
        if not isinstance(index, int):
            raise ValueError(f"{type(self).__name__} requires a single integer index.")
        self.index = index

    def __repr__(self):
        return super().__repr__() + f"_{self.index}"


class Measurement(SingleModeGate):
    def __init__(self, index, result=None, **kwargs):
        if kwargs.pop("dagger", None):
            logger.info(type(self).__name__ + " gates ignore adjoint/dagger.")
        super().__init__(index, **kwargs)
        self.result = result

    def __repr__(self):
        extra = f" = {round(self.result, REPR_DIGITS)}" if isinstance(self.result, float) else ""
        return super().__repr__() + extra

    @abstractmethod
    def apply(self, mps: MPS, **kwargs) -> MeasurementResult:
        ...


class TwoModeGate(Gate):
    def __init__(self, index1: int, index2: int, **kwargs):
        super().__init__(**kwargs)
        if not isinstance(index1, int) or not isinstance(index2, int):
            raise ValueError(f"{type(self).__name__} requires exactly two indices.")
        if abs(index1 - index2) != 1:
            raise ValueError(
                f"{type(self).__name__} can only be applied to neighbours, "
                f"but indices: {(index1, index2)} were given."
            )
        self.index1, self.index2 = index1, index2
        self.left_index, self.right_index = sorted([index1, index2])

    def __repr__(self):
        return super().__repr__() + f"_{self.index1},{self.index2}"
