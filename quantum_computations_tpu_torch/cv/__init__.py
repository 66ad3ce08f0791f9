"""Continuous-variable grid-MPS simulator of the port (counterpart of
``quantum_computations_tpu/cv``).

The state is an MPS whose modes are wavefunctions sampled on an
equidistant grid ``qs``; gates act by contraction, grid transforms and a
truncated SVD. Entry point: ``Simulator(gates, rng_seed=...).run(mps)``.
"""

from .mps import MPS, tensor_svd
from .states import State, eval_gkp_state
from .simulator import Simulator
from . import gates

__all__ = ["MPS", "tensor_svd", "State", "eval_gkp_state", "Simulator", "gates"]
