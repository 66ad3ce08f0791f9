"""Randomised benchmarking at production parameters on the card
(counterpart of ``quantum_computations_tpu/pipelines/rb_batched.py``).

Drives :class:`..gkp.batched.BatchedGKP` in its production configuration
(op granularity, adaptive trims, fused gadgets, host rank tracking): per
(dB, depth) cell, random circuits of ``batch`` trajectories each, every
trajectory's raw (not normalised) logical density scored against the
exact DV state: fidelity <psi|rho|psi>, purity tr(rho^2) and the raw
trace. Output: ``.dat`` rows of {db, depth, fidelity, purity, trace} and a
``.meta.json`` row per cell, the JAX package's schemas, with ``engine``
naming the port's settings.

``RBBatchedConfig.threads`` engines per dB (the JAX package's
``QCT_RB_THREADS``; the port reads no environment knob) sample a cell in
as many Python threads, each engine on a CUDA stream of its own
(:func:`.common.run_engines`): while one waits on a fetch or a cuSOLVER
``eigh``, another's dispatches keep the card busy.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from timeit import default_timer as timer

import numpy as np
import torch

from ..config import complex_dtype
from ..dv.states import State as DVState
from ..gkp import db2eps
from ..gkp.batched import BatchedGKP
from ..gkp.compiled import logical_coeffs
from ..ops import streamed
from .common import config_cli, prepare_output, run_engines, write_data
from .rb import random_circ

logger = logging.getLogger(__name__)


def _dv_state_np(circ, N: int) -> np.ndarray:
    """Exact DV reference state of a gate list from |0...0>, in numpy."""
    psi = np.zeros(2 ** N, dtype=np.complex128)
    psi[0] = 1.0
    for g in circ:
        U = np.asarray(g.matrix, dtype=np.complex128)
        idx = list(g.indices)
        k = len(idx)
        perm = idx + [i for i in range(N) if i not in idx]
        t = np.transpose(psi.reshape([2] * N), perm).reshape(2 ** k, -1)
        t = (U @ t).reshape([2] * N)
        psi = np.transpose(t, np.argsort(perm)).reshape(-1)
    return psi


def sample_depth_batched(runner: BatchedGKP, db: float, depth: int,
                         num_samples: int, batch: int, rng,
                         stats: dict | None = None,
                         runners: list[BatchedGKP] | None = None) -> list[dict]:
    """RB samples for one (db, depth) cell: full batches of ``batch``
    trajectories of freshly drawn random circuits until ``num_samples``
    rows, each scored against the exact DV state.

    Non-finite trajectories are dropped and resampled, and counted in
    ``stats`` ({"attempted", "dropped"}); a cell aborts after
    3 num_samples + 3 batch attempts.

    ``runners`` (more than one): one circuit-batch stream per engine, in
    Python threads on CUDA streams of their own. Every row is still a
    full batch of a freshly drawn circuit, but which thread draws which
    circuit depends on the interleaving, so the dataset's composition is
    not bit-reproducible.
    """
    N = 2
    rng = np.random.default_rng(rng)
    rows: list[dict] = []
    stats = stats if stats is not None else {}
    stats.setdefault("attempted", 0)
    stats.setdefault("dropped", 0)
    max_attempts = 3 * num_samples + 3 * batch
    lock = threading.Lock()
    errors: list[Exception] = []

    def work(r: BatchedGKP):
        while True:
            with lock:
                if len(rows) >= num_samples or errors:
                    return
                if stats["attempted"] >= max_attempts:
                    raise RuntimeError(
                        f"cell (db={db}, depth={depth}): {stats['dropped']} "
                        f"of {stats['attempted']} trajectories non-finite — "
                        "aborting instead of resampling forever")
                stats["attempted"] += batch  # reserve this engine's batch
                dv_circ, gkp_circ = random_circ(N, depth, rng)
                seed = int(rng.integers(2**31))
            t_batch = timer()
            tensors, frames = r.run_circuit(
                gkp_circ, logical_coeffs([DVState.ZERO] * N), batch, rng_seed=seed)
            rho_re, rho_im = (x.cpu().numpy() for x in r.readout(tensors, frames))
            scored, dropped = _score_batch(rho_re, rho_im,
                                           _dv_state_np(dv_circ, N), db, depth)
            with lock:
                rows.extend(scored)
                stats["dropped"] += dropped
                logger.info("db=%.3f depth=%d: batch of %d in %.0fs (%d/%d)",
                            db, depth, batch, timer() - t_batch, len(rows),
                            num_samples)

    runners = runners or [runner]
    if len(runners) > 1:
        run_engines(work, runners, errors)
    else:
        work(runners[0])
    return rows


def _score_batch(rho_re, rho_im, psi, db, depth):
    """Score one batch readout: (rows, dropped)."""
    scored: list[dict] = []
    dropped = 0
    for t in range(rho_re.shape[0]):
        rho = rho_re[t] + 1j * rho_im[t]
        tr = np.trace(rho).real
        if not np.isfinite(tr) or tr <= 0:
            dropped += 1
            logger.warning("dropping non-finite trajectory (trace=%s)", tr)
            continue
        scored.append({
            "db": float(db), "depth": int(depth),
            "fidelity": float(np.real(np.conj(psi) @ rho @ psi)),
            "purity": float(np.trace(rho @ rho).real),
            "trace": float(tr),
        })
    return scored, dropped


@dataclasses.dataclass
class RBBatchedConfig:
    """Production-parameter GKP RB sweep on the card."""

    dbs: str = "5.833,6.667,7.5"      # reference dbs[1:4] of linspace(5,15,13)
    depths: str = "8,10,15,20"
    num_samples: int = 16             # per (db, depth) cell
    batch: int = 16                   # trajectories per random circuit
    grid_points: int = 1000
    grid_span: float = 20.0
    max_bond_dim: int = 100
    rel_err: float = 1e-2
    rng_seed: int = 0
    data_file: str = "gkp_rb_batched.dat"
    overwrite: bool = False
    device: str = "cuda"
    threads: int = 1                  # engines (and CUDA streams) per dB


def main(config: RBBatchedConfig | None = None):
    config = config or RBBatchedConfig()
    if config.data_file:
        prepare_output(config.data_file, config.overwrite)
    qs = np.linspace(-config.grid_span, config.grid_span, config.grid_points)
    svd = {"rel_err": config.rel_err, "max_bond_dim": config.max_bond_dim}
    rng = np.random.default_rng(config.rng_seed)

    data: list[dict] = []
    meta: list[dict] = []
    n_threads = max(1, int(config.threads))
    for db in [float(x) for x in str(config.dbs).split(",")]:
        runners = [BatchedGKP(qs, float(db2eps(db)), svd, adaptive=True,
                              granularity="op", device=config.device)
                   for _ in range(n_threads)]
        runner = runners[0]
        for depth in [int(x) for x in str(config.depths).split(",")]:
            t0 = timer()
            stats: dict = {}
            cell = sample_depth_batched(runner, db, depth, config.num_samples,
                                        config.batch, rng, stats, runners=runners)
            data += cell
            dt = timer() - t0
            fids = [r["fidelity"] for r in cell]
            meta.append({
                "db": float(db), "depth": int(depth),
                "samples": len(cell), "batch": int(config.batch),
                "attempted": stats["attempted"], "dropped": stats["dropped"],
                "drop_rate": stats["dropped"] / max(1, stats["attempted"]),
                "seconds": round(dt, 1),
                "sec_per_traj": round(dt / max(1, stats["attempted"]), 2),
                "mean_fidelity": float(np.mean(fids)),
                "sem_fidelity": float(np.std(fids) / np.sqrt(len(fids))),
                "engine": {
                    "port": "torch",
                    "device": (torch.cuda.get_device_name(runner.device)
                               if runner.device.type == "cuda" else "cpu"),
                    "dtype": str(complex_dtype(runner.device)),
                    "fused_single": runner.fused_single,
                    "fused_pair": runner.fused_pair,
                    "rank_track": runner._tracking_active,
                    "power_iters": streamed.effective_power_iters(4),
                    "bs_decomp": streamed._BS_DECOMP,
                    "threads": n_threads,
                },
            })
            logger.info("db=%.3f depth=%d: %d samples in %.1fs (%d dropped)",
                        db, depth, len(cell), dt, stats["dropped"])
            if config.data_file:
                write_data(config.data_file, data)
                write_data(config.data_file + ".meta.json", meta)
    return data


if __name__ == "__main__":
    main(config_cli(RBBatchedConfig))
