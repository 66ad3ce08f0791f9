"""Randomised benchmarking on the whole-circuit engine (counterpart of
``quantum_computations_tpu/pipelines/rb_compiled.py``).

Each random MB-Clifford circuit runs as one :class:`..gkp.compiled.CompiledGKP`
program over a batch of trajectories: the GKP trajectories, the exact DV
state, the logical readout, the syndrome correction and the fidelity and
purity scores all stay on the device until one fetch of the scores per
circuit. Output: ``gkp_rb.dat`` rows of {db, depth, fidelity, purity}.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SVDOptions, complex_dtype, resolve_device, to_device
from ..dv import qop
from ..dv.states import State as DVState
from ..gkp.compiled import CompiledGKP, logical_coeffs
from ..utils import as_generator
from .common import config_cli, prepare_output, write_data
from .rb import random_circ


def _dv_state_in_trace(dv_circ, N: int, device=None) -> torch.Tensor:
    """Exact DV final state from |0...0>: torch ops in complex128 on the
    host (a few 2^N vectors), then one copy to ``device`` (default
    ``cuda``) in its complex dtype that does not wait for the device."""
    device = resolve_device(device)
    state = torch.zeros((2**N,), dtype=torch.complex128)
    state[0] = 1.0
    for gate in dv_circ:
        state = qop.apply_unitary(state, gate.matrix, tuple(gate.indices))
    return to_device(state, device).to(complex_dtype(device))


def make_scored_trajectory(prog: CompiledGKP, dv_circ, init_states: list[DVState]):
    """fn(n, rng_seed) -> (fidelity, purity), (n,) device tensors: ``n``
    scored RB trajectories of one circuit, the raw rho against the exact DV
    state."""
    coeffs = logical_coeffs(init_states)

    def fn(n: int, rng_seed=None):
        _, rho_re, rho_im = prog.trajectory_with_readout(coeffs, rng_seed, n=n)
        rho = torch.complex(rho_re, rho_im)
        psi = _dv_state_in_trace(dv_circ, prog.N, prog.device).to(rho.dtype)
        fidelity = torch.einsum("a,zab,b->z", psi.conj(), rho, psi).real
        purity = torch.einsum("zab,zba->z", rho, rho).real
        return fidelity, purity

    return fn


def sample_depth_compiled(db: float, depth: int, num_circuits: int,
                          traj_per_circuit: int, rng_seed=0, *,
                          grid_points: int = 512, grid_span: float = 20.0,
                          max_bond_dim: int = 16, rel_err: float = 1e-2,
                          device=None) -> list[dict]:
    """RB samples: num_circuits random circuits x traj_per_circuit
    trajectories. Circuits come from a numpy generator seeded with
    ``rng_seed``, the trajectories' draws from one torch generator."""
    from ..gkp import db2eps

    N = 2
    qs = np.linspace(-grid_span, grid_span, grid_points)
    eps = float(db2eps(db))
    svd = SVDOptions(max_bond_dim=max_bond_dim, rel_err=rel_err)
    circ_rng = np.random.default_rng(
        rng_seed if isinstance(rng_seed, (int, np.integer)) else None
    )
    generator = as_generator(rng_seed if isinstance(rng_seed, (int, np.integer)) else None)

    samples = []
    for _ in range(num_circuits):
        dv_circ, gkp_circ = random_circ(N, depth, circ_rng)
        prog = CompiledGKP(gkp_circ, qs, eps, svd, device=device)
        fn = make_scored_trajectory(prog, dv_circ, [DVState.ZERO] * N)
        fids, purs = fn(traj_per_circuit, generator)
        scores = torch.stack([fids, purs], -1).double().cpu().numpy()
        for f, p in scores:
            samples.append({
                "db": float(db), "depth": int(depth),
                "fidelity": float(f), "purity": float(p),
            })
    return samples


@dataclasses.dataclass
class RBCompiledConfig:
    """RB sweep on the whole-circuit engine (gkp_rb.dat schema)."""

    dbs: str = "5.83,6.67,7.5"
    depths: str = "4,8"
    num_circuits: int = 4
    traj_per_circuit: int = 16
    grid_points: int = 512
    max_bond_dim: int = 16
    rel_err: float = 1e-2
    rng_seed: int = 0
    data_file: str = "gkp_rb_compiled.dat"
    overwrite: bool = False
    device: str = "cuda"


def main(config: RBCompiledConfig | None = None):
    config = config or RBCompiledConfig()
    prepare_output(config.data_file, config.overwrite)
    data = []
    for db in [float(x) for x in str(config.dbs).split(",")]:
        for depth in [int(x) for x in str(config.depths).split(",")]:
            data += sample_depth_compiled(
                db, depth, config.num_circuits, config.traj_per_circuit,
                config.rng_seed, grid_points=config.grid_points,
                max_bond_dim=config.max_bond_dim, rel_err=config.rel_err,
                device=config.device,
            )
            if config.data_file:
                write_data(config.data_file, data)
    return data


if __name__ == "__main__":
    main(config_cli(RBCompiledConfig))
