"""GKP Grover sweep on the whole-circuit engine (counterpart of
``quantum_computations_tpu/pipelines/grover_compiled.py``).

:class:`..gkp.compiled.CompiledGKP` runs the measurement-based Grover
circuit, the logical readout and the syndrome correction over a batch of
trajectories per dB; rows follow the ``gkp_grover_*.dat`` schema
{epsilon, rho_real, rho_imag}. Bond caps are static (no trims), so a
macronode's contraction grows as (chi d)^2 per trajectory: this pipeline
targets moderate caps; production (chi = 100, d = 1000) runs through
:mod:`.grover_batched`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SVDOptions
from ..gkp import MBGKPCircuit, db2eps
from ..gkp.compiled import CompiledGKP, logical_coeffs
from .common import config_cli, prepare_output, write_data
from .grover import grover, success_probability


@dataclasses.dataclass
class GroverCompiledConfig:
    """GKP Grover sweep on the whole-circuit engine (gkp_grover schema)."""

    tagged: str = "2,7"
    dbs: str = "6.67,8.33,10.0"
    traj_per_db: int = 8
    grid_points: int = 512
    grid_span: float = 20.0
    max_bond_dim: int = 8
    rel_err: float = 1e-2
    rng_seed: int = 0
    data_file: str = "gkp_grover_compiled.dat"
    overwrite: bool = False
    device: str = "cuda"


def main(config: GroverCompiledConfig | None = None):
    config = config or GroverCompiledConfig()
    tagged = [int(x) for x in str(config.tagged).split(",")]
    circuit, init = grover(tagged)
    gkp_circuit = MBGKPCircuit.transpile(circuit)
    gkp_circuit.fill()

    qs = np.linspace(-config.grid_span, config.grid_span, config.grid_points)
    svd = SVDOptions(max_bond_dim=config.max_bond_dim, rel_err=config.rel_err)
    coeffs = logical_coeffs(init)

    prepare_output(config.data_file, config.overwrite)
    data = []
    for i, db in enumerate([float(x) for x in str(config.dbs).split(",")]):
        eps = float(db2eps(db))
        prog = CompiledGKP(gkp_circuit, qs, eps, svd, device=config.device)
        _, rho_re, rho_im = prog.batched_readout(
            coeffs, config.traj_per_db, rng_seed=config.rng_seed + i,
        )
        rho = rho_re.double().cpu().numpy() + 1j * rho_im.double().cpu().numpy()
        for t in range(config.traj_per_db):
            data.append({
                "epsilon": eps,
                "rho_real": rho[t].real.tolist(),
                "rho_imag": rho[t].imag.tolist(),
            })
        if config.data_file:
            write_data(config.data_file, data)
    return data


def summarize(data, tagged):
    """Mean success per epsilon."""
    from collections import defaultdict
    by = defaultdict(list)
    for entry in data:
        rho = np.array(entry["rho_real"]) + 1j * np.array(entry["rho_imag"])
        by[round(entry["epsilon"], 9)].append(success_probability(rho, tagged))
    return {eps: float(np.mean(v)) for eps, v in sorted(by.items())}


if __name__ == "__main__":
    cfg = config_cli(GroverCompiledConfig)
    data = main(cfg)
    print(summarize(data, [int(x) for x in str(cfg.tagged).split(",")]))
