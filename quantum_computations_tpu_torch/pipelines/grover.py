"""GKP Grover pipeline on the eager engine (counterpart of
``quantum_computations_tpu/pipelines/grover.py``).

CZ-only Grover circuits, the small ``test_circuit``, ``run_simulation``
(one :class:`..gkp.Simulator` trajectory, its logical density and the
syndrome correction, returned as complex128 numpy), the raw success metric
and the dB sweep writing ``gkp_grover.dat`` rows of {epsilon, rho_real,
rho_imag}. The engine runs on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
import logging
from timeit import default_timer as timer

import numpy as np

from ..cv.mps import MPS
from ..dv import gates as dv_gates
from ..dv.states import State as DVState
from ..gkp import (
    MBGKPCircuit, Simulator as GKPSimulator, db2eps, full_logical_density_mps,
    parse_to_mps, syndrome_matrix,
)
from . import circuits as ccs
from .common import config_cli, prepare_output, write_data

logger = logging.getLogger(__name__)


def grover(tagged: list[int]) -> tuple[list[dv_gates.Gate], list[DVState]]:
    """Grover circuit in CZ-only form (CX replaced by H CZ H), with the three
    leading Inserts converted to an initial-state list."""
    circuit = ccs.grover(ccs.oracle(tagged))
    circuit = circuit[3:]  # drop Insert(ZERO) x3
    init = [DVState.ZERO] * 3
    out = []
    for gate in circuit:
        if isinstance(gate, dv_gates.CX):
            out.append(dv_gates.H(gate.target))
            out.append(dv_gates.CZ(*gate.indices))
            out.append(dv_gates.H(gate.target))
        else:
            out.append(gate)
    return out, init


def test_circuit() -> tuple[list[dv_gates.Gate], list[DVState]]:
    """Small smoke-test circuit (reference grover.py:55-69)."""
    circuit = [
        dv_gates.P(0), dv_gates.H(1), dv_gates.X(0), dv_gates.Z(0),
        dv_gates.T(0), dv_gates.T(1), dv_gates.CZ(0, 1),
        dv_gates.H(0), dv_gates.H(1),
    ]
    return circuit, [DVState.H, DVState.H]


def run_simulation(simulator: GKPSimulator, init: MPS) -> np.ndarray:
    """One trajectory -> syndrome-corrected logical density matrix
    (complex128 numpy, not normalised)."""
    mps, syndromes = simulator.run(init.copy())
    rho = full_logical_density_mps(mps).cpu().resolve_conj().numpy().astype(np.complex128)
    correction = syndrome_matrix(syndromes).numpy()
    return correction @ rho @ correction.T


def success_probability(rho: np.ndarray, tagged: list[int]) -> float:
    """Grover success metric (reference plot_data.ipynb cell 11: RAW
    diagonal of the stored rho — the notebook does not trace-normalise)."""
    return float(np.sum(np.diag(rho).real[list(tagged)]))


@dataclasses.dataclass
class GroverConfig:
    """GKP Grover dB sweep."""

    tagged: str = "2,7"
    db_min: float = 5.0
    db_max: float = 15.0
    db_points: int = 13
    db_skip: int = 2           # reference: linspace(5,15,13)[2:]
    repeats: int = 20
    grid_points: int = 1000
    grid_span: float = 20.0
    max_bond_dim: int = 100
    rel_err: float = 1e-2
    rng_seed: int = 42
    data_file: str = "gkp_grover.dat"
    log_file: str = ""
    overwrite: bool = False
    device: str = "cuda"


def main(config: GroverConfig | None = None, progress: bool = True):
    config = config or GroverConfig()
    tagged = [int(x) for x in str(config.tagged).split(",")]
    circuit, init = grover(tagged)
    dbs = np.linspace(config.db_min, config.db_max, config.db_points)[config.db_skip:]
    dbs = np.tile(dbs, config.repeats)

    prepare_output(config.data_file, config.overwrite)
    if config.log_file:
        logging.basicConfig(level=logging.INFO, filename=config.log_file)

    qs = np.linspace(-config.grid_span, config.grid_span, config.grid_points)
    svd_options = {"rel_err": config.rel_err, "max_bond_dim": config.max_bond_dim}

    gkp_circuit = MBGKPCircuit.transpile(circuit)
    gkp_circuit.fill()
    simulator = GKPSimulator(
        gkp_circuit, ancilla_epsilon=None, rng_seed=config.rng_seed,
        svd_options=svd_options,
    )

    iterator = enumerate(dbs)
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(list(iterator), smoothing=0.0)
        except ImportError:
            pass

    data = []
    for i, db in iterator:
        logger.info(f"Starting MB GKP simulation {i+1} of {len(dbs)} at {db} dB")
        eps = float(db2eps(db))
        simulator._epsilon = eps
        t0 = timer()
        rho = run_simulation(simulator, parse_to_mps(init, eps, qs, device=config.device))
        t1 = timer()
        data.append({
            "epsilon": eps,
            "rho_real": rho.real.tolist(),
            "rho_imag": rho.imag.tolist(),
        })
        if config.data_file:
            write_data(config.data_file, data)
        logger.info(f"Finished in {t1 - t0:.1f}s")
    return data


if __name__ == "__main__":
    main(config_cli(GroverConfig))
