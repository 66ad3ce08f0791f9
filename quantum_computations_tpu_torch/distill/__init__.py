"""Logical-distillation sequence analysis and search (CPU, exact arithmetic):
the port's own copy of ``quantum_computations_tpu/distill``, with its data
(``code_data/``), so that the port imports nothing of the JAX package.

Capability parity with the reference project
``fault-tolerant_interfaces_for_modular_quantum_computing_on_diverse_qubit_platforms``.
This subsystem is deliberately NOT accelerator code: it is mpmath/sympy
symbolic+arbitrary-precision work (dps=80 is load-bearing for the committed
result datasets) and stays on the host, exactly as SURVEY.md §7.5 prescribes.

- :mod:`.hardware`   — surface-code/bulk-seam error & rate models
- :mod:`.repetition` — [n,1,n] repetition-code evaluator (vendored sympy data)
- :mod:`.sequence`   — Stage classes + LogicalDistillationSequence recurrences
- :mod:`.codes`      — the distillation codes table (stdlib xlsx reader)
- :mod:`.optimizer`  — dominance-pruned DFS over stage sequences
- :mod:`.simulation` — discrete-time Monte-Carlo pipeline simulator
"""

from .hardware import (
    DepolarisationChannel, balanced_depolarisation_noise, find_code_size,
    find_root_bisection, lattice_surgery_gate_rate, logical_error_rate_bulk_seam,
    surface_code_error, surface_code_qubits, surface_code_size,
    surface_code_size_bulk_seam, transversal_gate_rate,
)
from .repetition import ED_n_1_n
from .sequence import (
    ClassicalStage, GrowStage, InitStage, InjectionStage, LogicalDistillationSequence,
    QuantumStage, Stage, scalar_error,
)
from .codes import load_codes_table
from .optimizer import CachedPruner, DFSArgs, dfs_code_sequence
from .simulation import Simulator

__all__ = [
    "DepolarisationChannel", "balanced_depolarisation_noise", "find_code_size",
    "find_root_bisection", "lattice_surgery_gate_rate", "logical_error_rate_bulk_seam",
    "surface_code_error", "surface_code_qubits", "surface_code_size",
    "surface_code_size_bulk_seam", "transversal_gate_rate", "ED_n_1_n",
    "ClassicalStage", "GrowStage", "InitStage", "InjectionStage",
    "LogicalDistillationSequence", "QuantumStage", "Stage", "scalar_error",
    "load_codes_table", "CachedPruner", "DFSArgs", "dfs_code_sequence",
    "Simulator",
]
