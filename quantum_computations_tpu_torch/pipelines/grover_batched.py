"""Grover at production parameters on the card (counterpart of
``quantum_computations_tpu/pipelines/grover_batched.py``).

Drives the CZ-only Grover circuit through :class:`..gkp.batched.BatchedGKP`
in its production configuration (op granularity, adaptive trims, fused
gadgets, host rank tracking; two-mode splits above the stream threshold
streamed): chi = 100 on a 1000-point grid. Non-finite trajectories are
dropped and resampled, up to 3 trajectories + 3 batch attempts per dB.
Output: ``gkp_grover_*.dat`` rows of {epsilon, rho_real, rho_imag,
simulation_time, rng_seed, rng_lane} and a ``.meta.json`` row per dB, the
JAX package's schemas; :func:`summarize` gives the mean success per
epsilon.

``GroverBatchedConfig.threads`` engines per dB run in as many Python
threads, each on a CUDA stream of its own (:func:`.common.run_engines`);
every batch is then a full ``batch``, its seed is reserved under the lock,
and rows keep unique (``rng_seed``, ``rng_lane``) provenance, while the
dataset's order depends on the interleaving. More than one engine slows
Grover down on the card (its host work is Python under the GIL), so the
default is 1.

Deliberate differences from the JAX package: ``threads`` is a config field
in place of ``QCT_GROVER_THREADS``; no compile cache
(``setup_compile_cache`` is XLA's); the meta's ``engine`` entries for the
JAX package's environment knobs record the port's fixed settings (host
eigh, gram and prerot pair paths on, full FP32 products).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from timeit import default_timer as timer

import numpy as np

from ..gkp import MBGKPCircuit, db2eps
from ..gkp.batched import BatchedGKP
from ..gkp.compiled import logical_coeffs
from ..ops import streamed
from .common import config_cli, prepare_output, run_engines, write_data
from .grover import grover, success_probability

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GroverBatchedConfig:
    """Production-parameter GKP Grover on the card."""

    tagged: str = "0,4"        # reference production oracle (grover.py:107-111)
    dbs: str = "12.5"
    trajectories: int = 20     # per dB value
    batch: int = 10            # trajectories per engine run
    grid_points: int = 1000
    grid_span: float = 20.0
    max_bond_dim: int = 100
    rel_err: float = 1e-2
    rng_seed: int = 42
    data_file: str = "gkp_grover_batched.dat"
    overwrite: bool = False
    device: str = "cuda"
    # engines (and CUDA streams) per dB; above 1 Grover runs slower: its
    # host work is Python under the GIL (PERF.md §5, phase 11a)
    threads: int = 1


def _engine_settings(runner: BatchedGKP, threads: int) -> dict:
    """The meta's ``engine`` entry, with the JAX package's keys."""
    return {
        "fused_single": runner.fused_single,
        "fused_pair": runner.fused_pair,
        "stream_eigh": "host",
        "power_iters": streamed._POWER_ITERS_ENV or str(streamed._DEFAULT_POWER_ITERS),
        "rank_track": runner._tracking_active,
        "pair_gram": "1",
        "exact_prerot": "1",
        "p1_prec": "highest",
        "tab_prec": "highest",
        "threads": threads,
    }


def main(config: GroverBatchedConfig | None = None):
    config = config or GroverBatchedConfig()
    tagged = [int(x) for x in str(config.tagged).split(",")]
    circuit, init = grover(tagged)
    gkp_circuit = MBGKPCircuit.transpile(circuit)
    gkp_circuit.fill()
    coeffs = logical_coeffs(init)

    if config.data_file:
        prepare_output(config.data_file, config.overwrite)
    qs = np.linspace(-config.grid_span, config.grid_span, config.grid_points)
    svd = {"rel_err": config.rel_err, "max_bond_dim": config.max_bond_dim}

    data: list[dict] = []
    meta: list[dict] = []
    n_threads = max(1, int(config.threads))
    for i, db in enumerate([float(x) for x in str(config.dbs).split(",")]):
        eps = float(db2eps(db))
        runners = [BatchedGKP(qs, eps, svd, adaptive=True, granularity="op",
                              device=config.device) for _ in range(n_threads)]
        st = {"kept": 0, "attempted": 0, "dropped": 0}
        max_attempts = 3 * config.trajectories + 3 * config.batch
        lock = threading.Lock()
        errors: list[Exception] = []
        t_db = timer()

        def work(r: BatchedGKP):  # every thread has joined before the next dB
            while True:
                with lock:
                    if st["kept"] >= config.trajectories or errors:
                        return
                    if st["attempted"] >= max_attempts:
                        raise RuntimeError(
                            f"db={db}: {st['dropped']}/{st['attempted']} "
                            "trajectories non-finite — aborting instead of "
                            "resampling forever")
                    n = (config.batch if n_threads > 1
                         else min(config.batch, config.trajectories - st["kept"]))
                    batch_seed = config.rng_seed + 1000 * i + st["attempted"]
                    st["attempted"] += n
                t0 = timer()
                tensors, frames = r.run_circuit(gkp_circuit, coeffs, n,
                                                rng_seed=batch_seed)
                rho_re, rho_im = (x.double().cpu().numpy()
                                  for x in r.readout(tensors, frames))
                batch_secs = timer() - t0
                scored = []
                for t in range(n):
                    rho = rho_re[t] + 1j * rho_im[t]
                    tr = np.trace(rho).real
                    if not np.isfinite(tr) or tr <= 0:
                        logger.warning("dropping non-finite trajectory")
                        continue
                    scored.append({
                        "epsilon": eps,
                        "rho_real": rho.real.tolist(),
                        "rho_imag": rho.imag.tolist(),
                        # the batch's wall time shared by its trajectories;
                        # provenance (batch seed, lane in the batch)
                        "simulation_time": round(batch_secs / n, 3),
                        "rng_seed": int(batch_seed), "rng_lane": int(t),
                    })
                with lock:
                    st["kept"] += len(scored)
                    st["dropped"] += n - len(scored)
                    data.extend(scored)
                    logger.info("db=%.2f: %d/%d trajectories (%.0fs/batch)",
                                db, st["kept"], config.trajectories, batch_secs)
                    if config.data_file:
                        write_data(config.data_file, data)

        if n_threads > 1:
            run_engines(work, runners, errors)
        else:
            work(runners[0])
        dt = timer() - t_db
        meta.append({
            "db": float(db), "epsilon": eps, "samples": st["kept"],
            "attempted": st["attempted"], "dropped": st["dropped"],
            "drop_rate": st["dropped"] / max(1, st["attempted"]),
            "seconds": round(dt, 1),
            "sec_per_traj": round(dt / max(1, st["attempted"]), 2),
            "engine": _engine_settings(runners[0], n_threads),
        })
        if config.data_file:
            write_data(config.data_file + ".meta.json", meta)
    return data


def summarize(data, tagged):
    """Mean Grover success per epsilon and its standard error (reference
    plot_data.ipynb cell 11)."""
    from collections import defaultdict
    by = defaultdict(list)
    for entry in data:
        rho = np.asarray(entry["rho_real"]) + 1j * np.asarray(entry["rho_imag"])
        by[entry["epsilon"]].append(success_probability(rho, tagged))
    return {eps: (float(np.mean(v)), float(np.std(v) / np.sqrt(len(v))))
            for eps, v in sorted(by.items())}


if __name__ == "__main__":
    main(config_cli(GroverBatchedConfig))
