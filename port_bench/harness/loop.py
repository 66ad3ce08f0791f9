"""The closed loop that the measured window drives.

Each client is one ``BatchedGKP`` in its production configuration. A
client takes the next job from the traffic (under one lock: the circuit's
gates, the port's transpiled circuit, the batch seed), runs
``run_circuit`` and ``readout``, copies the densities to the host, scores
them, and takes the next job; it stops taking jobs at the deadline and
finishes the batch it holds. One client runs in the calling thread; more
run through the port's ``pipelines.common.run_engines``, one Python thread
and one CUDA stream each, as the pipelines run them. The warm-up runs the
clients' batches one after another (``serial``), each in its own thread,
so that set-up does the same work in every run and leaves each thread's
library handles made for the window's threads to take up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass
class Job:
    """One batch of trajectories of one circuit."""

    gates: list            # DV gates [(name, indices)]
    N: int
    coeffs: np.ndarray     # (N, 2, 2) float32 initial logical coefficients
    batch: int
    seed: int              # the batch's rng_seed
    circuit: object        # the port's transpiled, filled MBGKPCircuit


@dataclasses.dataclass
class Batch:
    job: Job
    client: int            # index of the engine that ran it
    rho: np.ndarray        # (B, 2^N, 2^N) complex, as read out to the host
    frames: np.ndarray     # (B, N, 2)
    tape: object           # record.BatchTape
    scores: list
    failed: int            # trajectories with a non-finite or non-positive trace
    start: float
    end: float


def make_engines(config: dict, db: float, device, clients: int) -> list:
    """One ``BatchedGKP`` per client at the configuration's grid, cap and
    rel_err, in its production configuration."""
    import torch

    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    from port_bench.reference.engine import db2eps

    span = float(config["grid_span"])
    qs = np.linspace(-span, span, int(config["grid_points"]))
    svd = {"rel_err": float(config["rel_err"]), "max_bond_dim": int(config["max_bond_dim"])}
    engines = [BatchedGKP(qs, db2eps(db), svd, adaptive=True, granularity="op", device=device)
               for _ in range(clients)]
    if torch.device(device).type == "cuda":
        # load CUDA's linear-algebra library from this thread: its lazy
        # loader fails when engine threads make their first calls together
        torch.linalg.eigh(torch.eye(2, dtype=torch.complex128, device=device))
    return engines


def run_clients(engines, next_job, score, recorder, *, deadline: float | None = None,
                batches_per_client: int | None = None, serial: bool = False) -> list[Batch]:
    """Drive every engine in closed loop until ``deadline`` (perf_counter
    seconds) or for ``batches_per_client`` batches each; with ``serial``,
    one batch at a time, every thread staying until all are done."""
    from quantum_computations_tpu_torch.pipelines.common import run_engines

    lock = threading.Lock()
    turn = threading.Lock() if serial else contextlib.nullcontext()
    barrier = threading.Barrier(len(engines)) if serial and len(engines) > 1 else None
    clients = {id(e): i for i, e in enumerate(engines)}
    done: list[Batch] = []
    errors: list[Exception] = []

    def work(engine):
        try:
            with turn:
                batches(engine)
        finally:
            if barrier is not None:
                barrier.wait()

    def batches(engine):
        n = 0
        while True:
            with lock:
                if errors:
                    return
                if batches_per_client is not None and n >= batches_per_client:
                    return
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                job = next_job()
            n += 1
            start = time.perf_counter()
            tape = recorder.start()
            tensors, frames = engine.run_circuit(job.circuit, job.coeffs, job.batch,
                                                 rng_seed=job.seed)
            re, im = (x.cpu().numpy() for x in engine.readout(tensors, frames))
            recorder.stop()
            del tensors
            rho = re + 1j * im
            tr = np.trace(rho, axis1=1, axis2=2).real
            failed = int(np.sum(~(np.isfinite(tr) & (tr > 0))))
            scores = score(job, rho)
            end = time.perf_counter()
            with lock:
                done.append(Batch(job, clients[id(engine)], rho, np.asarray(frames), tape, scores,
                                  failed, start, end))

    if len(engines) == 1:
        work(engines[0])
    else:
        run_engines(work, engines, errors)
    return done
