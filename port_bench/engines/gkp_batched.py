"""The GKP trajectory engine, ``gkp/batched.BatchedGKP``, as the harness
drives it.

A client is one ``BatchedGKP`` in its production configuration. A job
(``drivers/common.Job``) is one batch of trajectories of one circuit: the
driver's DV gates, the port's transpiled circuit, the initial logical
coefficients and the batch seed. Running it is ``run_circuit`` and
``readout``, with the densities copied to the host; a trajectory fails
where its density's trace is not finite or not positive. The window's
draws are kept by ``engines/gkp/record.DrawRecorder``, and
``engines/gkp/check`` replays checked batches through the plain reference
at the traffic's squeezing (``db``).
"""

from __future__ import annotations

import numpy as np


def make_engines(config: dict, traffic: dict, device, clients: int) -> list:
    """One ``BatchedGKP`` per client at the configuration's grid, cap and
    rel_err and the traffic's squeezing, in its production configuration."""
    import torch

    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    from port_bench.reference.engine import db2eps

    span = float(config["grid_span"])
    qs = np.linspace(-span, span, int(config["grid_points"]))
    svd = {"rel_err": float(config["rel_err"]), "max_bond_dim": int(config["max_bond_dim"])}
    engines = [BatchedGKP(qs, db2eps(float(traffic["db"])), svd, adaptive=True,
                          granularity="op", device=device)
               for _ in range(clients)]
    if torch.device(device).type == "cuda":
        # load CUDA's linear-algebra library from this thread: its lazy
        # loader fails when engine threads make their first calls together
        torch.linalg.eigh(torch.eye(2, dtype=torch.complex128, device=device))
    return engines


def run_job(engine, job):
    """(densities (B, 2^N, 2^N) complex on the host, frames (B, N, 2), failed)."""
    tensors, frames = engine.run_circuit(job.circuit, job.coeffs, job.batch, rng_seed=job.seed)
    re, im = (x.cpu().numpy() for x in engine.readout(tensors, frames))
    del tensors
    rho = re + 1j * im
    tr = np.trace(rho, axis1=1, axis2=2).real
    return rho, np.asarray(frames), int(np.sum(~(np.isfinite(tr) & (tr > 0))))


def recorder():
    """The window's draw recorder."""
    from port_bench.engines.gkp.record import DrawRecorder

    return DrawRecorder()


def check(batches, chosen, config: dict, traffic: dict, limits: dict, device, log, rng) -> dict:
    """``engines/gkp/check.check`` at the traffic's squeezing."""
    from port_bench.engines.gkp import check as checking

    return checking.check(batches, chosen, config, float(traffic["db"]), limits, device, log, rng)


def describe(engines) -> str:
    return f"engine counts {dict(engines[0].counts)}; largest (a, b) {engines[0].largest}"
