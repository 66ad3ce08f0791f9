"""Randomised benchmarking of MB-GKP Clifford circuits on the eager
engine (counterpart of ``quantum_computations_tpu/pipelines/rb.py``).

Random circuits from {I, H, P, Pdg, CZ, SWAP} until the transpiled GKP
circuit reaches a target depth; each sampled circuit runs through
:class:`..gkp.Simulator` and the DV engine (:class:`..dv.Simulator`), and
the raw logical density is scored against the DV state: fidelity, purity
and the raw trace. Output: ``gkp_rb.dat`` rows of {db, depth, fidelity,
purity, trace}. The engines run on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
import logging
from timeit import default_timer as timer

import numpy as np
import torch

from ..dv import Simulator as DVSimulator, gates as dv_gates, qop
from ..dv.states import State as DVState
from ..gkp import MBGKPCircuit, Simulator as GKPSimulator, db2eps, parse_to_mps
from .common import config_cli, prepare_output, write_data
from .grover import run_simulation

logger = logging.getLogger(__name__)

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


def sample_depth(db: float, depth: int, num_samples: int, rng_seed,
                 *, grid_points: int = 1000, grid_span: float = 20.0,
                 max_bond_dim: int = 100, rel_err: float = 1e-2,
                 device=None) -> list[dict]:
    N = 2
    epsilon = float(db2eps(db))
    qs = np.linspace(-grid_span, grid_span, grid_points)
    svd_options = {"rel_err": rel_err, "max_bond_dim": max_bond_dim}
    rng = np.random.default_rng(rng_seed)
    init_dv = [DVState.ZERO] * N
    init_mps = parse_to_mps(init_dv, epsilon, qs, device=device)

    samples = []
    for _ in range(num_samples):
        dv_circ, gkp_circ = random_circ(N, depth, rng)
        sim = GKPSimulator(gkp_circ, epsilon, rng_seed=int(rng.integers(2**31)),
                           svd_options=svd_options)
        rho = run_simulation(sim, init_mps.copy())
        # raw rho: the reference scores the unnormalised logical density
        success = DVSimulator(dv_circ, device=device).run(init_dv).cpu()
        fidelity = float(qop.fidelity(torch.from_numpy(rho), success))
        purity = float(np.trace(rho @ rho).real)
        samples.append({"db": db, "depth": depth, "fidelity": fidelity, "purity": purity,
                        # beyond the reference schema: the raw trace
                        # (code-space leakage)
                        "trace": float(np.trace(rho).real)})
    return samples


@dataclasses.dataclass
class RBConfig:
    """GKP randomised-benchmarking sweep."""

    db_min: float = 5.0
    db_max: float = 15.0
    db_points: int = 13
    db_slice: str = "1:4"       # reference: dbs[1:4]
    db_repeats: int = 10
    depths: str = "8,10,15,15,20,20,20,20"
    num_samples: int = 10
    grid_points: int = 1000
    grid_span: float = 20.0
    max_bond_dim: int = 100
    rel_err: float = 1e-2
    rng_seed: int = 0
    data_file: str = "gkp_rb.dat"
    log_file: str = ""
    overwrite: bool = False
    device: str = "cuda"


def main(config: RBConfig | None = None):
    config = config or RBConfig()
    dbs = np.linspace(config.db_min, config.db_max, config.db_points)
    lo, hi = (int(x) if x else None for x in config.db_slice.split(":"))
    dbs = np.tile(dbs[lo:hi], config.db_repeats)
    depths = [int(d) for d in str(config.depths).split(",")]

    prepare_output(config.data_file, config.overwrite)
    if config.log_file:
        logging.basicConfig(level=logging.INFO, filename=config.log_file)

    rng = np.random.default_rng(config.rng_seed)
    data = []
    for db in dbs:
        t0 = timer()
        for depth in depths:
            data += sample_depth(
                db, int(depth), config.num_samples, rng,
                grid_points=config.grid_points, grid_span=config.grid_span,
                max_bond_dim=config.max_bond_dim, rel_err=config.rel_err,
                device=config.device,
            )
            if config.data_file:
                write_data(config.data_file, data)
        logger.info(f"Finished RB at {db} dB in {timer() - t0:.1f}s")
    return data


if __name__ == "__main__":
    main(config_cli(RBConfig))
