"""Measurement-based GKP-qubit simulator of the port, layered on its CV
engine (counterpart of ``quantum_computations_tpu/gkp``): teleportation
gadgets (single-mode) and macronode cluster gadgets (two-mode), a DV -> MB
transpiler with ASAP layering and a virtual Pauli frame, the eager
:class:`Simulator`, and the logical-density readout.
"""

from .utils import (
    db2eps, eps2db, decomp_result, format_result, cv2dv_information,
    syndrome_matrix, full_logical_density_mps, full_logical_density,
)
from .bell import GKPBellState, InsertBell
from .gates import (
    MBType, MB2Type, MeasurementBased, MBSingleMode, MBTwoMode,
    MBI, MBF, MBP, MBSWAP, MBCZ, MBT, GKPEC,
)
from .transpiler import MBGKPCircuit, gate_transpile, state_transpile, parse_to_mps
from .simulator import Simulator, SimulatorAlt, commute

__all__ = [
    "db2eps", "eps2db", "decomp_result", "format_result", "cv2dv_information",
    "syndrome_matrix", "full_logical_density_mps", "full_logical_density",
    "GKPBellState", "InsertBell", "MBType", "MB2Type", "MeasurementBased",
    "MBSingleMode", "MBTwoMode", "MBI", "MBF", "MBP", "MBSWAP", "MBCZ", "MBT",
    "GKPEC", "MBGKPCircuit", "gate_transpile", "state_transpile", "parse_to_mps",
    "Simulator", "SimulatorAlt", "commute",
]
