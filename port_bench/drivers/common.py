"""What the GKP drivers share: the job, initial coefficients and the port's
circuit."""

from __future__ import annotations

import dataclasses

import numpy as np

# logical (re, im) coefficients of |0> and |1> per named DV state
_STATES = {"ZERO": ((1.0, 0.0), (0.0, 0.0)), "ONE": ((0.0, 0.0), (1.0, 0.0))}


@dataclasses.dataclass
class Job:
    """One batch of trajectories of one circuit (``engines/gkp_batched``)."""

    gates: list            # DV gates [(name, indices)]
    N: int
    coeffs: np.ndarray     # (N, 2, 2) float32 initial logical coefficients
    batch: int
    seed: int              # the batch's rng_seed
    circuit: object        # the port's transpiled, filled MBGKPCircuit


def initial_coeffs(names) -> np.ndarray:
    """(N, 2, 2) float32 logical coefficients of a product of named states."""
    return np.asarray([_STATES[n] for n in names], np.float32)


def port_circuit(gates, N: int):
    """The port's filled measurement-based circuit of a DV gate list."""
    from quantum_computations_tpu_torch.dv import gates as dv_gates
    from quantum_computations_tpu_torch.gkp import MBGKPCircuit

    circuit = MBGKPCircuit.transpile([getattr(dv_gates, name)(*idx) for name, idx in gates], N)
    circuit.fill()
    return circuit
