"""Shared utilities of the port (counterpart of
``quantum_computations_tpu/utils``)."""

from .profiling import annotate, maybe_trace
from .rng import as_generator

__all__ = ["annotate", "as_generator", "maybe_trace"]
