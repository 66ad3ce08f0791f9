"""Random circuits of randomised benchmarking (counterpart of
``quantum_computations_tpu/pipelines/rb.py``): gates drawn from
{I, H, P, Pdg, CZ, SWAP} until the transpiled GKP circuit reaches a target
depth. The eager sweep (``sample_depth``, ``main``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..dv import gates as dv_gates
from ..gkp import MBGKPCircuit

GATE_LIST = (dv_gates.I, dv_gates.H, dv_gates.P, dv_gates.Pdg, dv_gates.CZ, dv_gates.SWAP)


def random_circ(N: int, depth: int, rng) -> tuple[list[dv_gates.Gate], MBGKPCircuit]:
    """Sample gates until the transpiled GKP circuit reaches `depth` layers;
    the same numpy seed draws the same circuit as the JAX package."""
    if N < 2:
        raise ValueError("At least 2 qubits required!")
    rng = np.random.default_rng(rng)
    dv_circ = []
    gkp_circ = MBGKPCircuit(N)
    while gkp_circ.depth() < depth:
        gate = rng.choice(GATE_LIST, 1)[0]
        if issubclass(gate, dv_gates.SingleQubitGate):
            i = int(rng.choice(range(N), 1)[0])
            dv_circ.append(gate(i))
            gkp_circ.add_gate(gate(i))
        else:
            i = int(rng.choice(range(N - 1), 1)[0])
            dv_circ.append(gate(i, i + 1))
            gkp_circ.add_gate(gate(i, i + 1))
    gkp_circ.fill()
    return dv_circ, gkp_circ
