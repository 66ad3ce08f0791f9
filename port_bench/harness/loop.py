"""The closed loop that the measured window drives.

A client is one engine of the cell's engine module
(``port_bench/engines/<engine_module>.py``). A client takes the next job
from the traffic (under one lock), runs it through the engine module's
``run_job``, which copies its outputs to the host, scores them, and takes
the next job; it stops taking jobs at the deadline and finishes the job it
holds. One client runs in the calling thread; more run through the port's
``pipelines.common.run_engines``, one Python thread and one CUDA stream
each, as the pipelines run them. The warm-up runs the clients' batches one
after another (``serial``), each in its own thread, so that set-up does
the same work in every run and leaves each thread's library handles made
for the window's threads to take up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time


@dataclasses.dataclass
class Batch:
    job: object            # the driver's job; ``job.batch`` trajectories
    client: int            # index of the engine that ran it
    out: object            # the engine's output on the host, which the driver scores
    aux: object            # what else of it the check compares (GKP: Pauli frames)
    tape: object           # the recorder's tape of the batch
    scores: list
    failed: int            # trajectories the engine module counts as failed
    start: float
    end: float


class NullRecorder:
    """A recorder for engines whose check needs no record of the window."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        return None

    def stop(self):
        pass


def _default_engine():
    import importlib

    from port_bench.harness.bench import DEFAULT_ENGINE

    return importlib.import_module(f"port_bench.engines.{DEFAULT_ENGINE}")


def make_engines(config: dict, db: float, device, clients: int) -> list:
    """The default engine module's clients at squeezing ``db`` dB, for
    callers that drive the loop without a cell (``tools/recording_cost.py``)."""
    return _default_engine().make_engines(config, {"db": db}, device, clients)


def run_clients(engines, next_job, score, recorder, *, run_job=None,
                deadline: float | None = None, batches_per_client: int | None = None,
                serial: bool = False) -> list[Batch]:
    """Drive every engine in closed loop, ``run_job(engine, job)`` giving
    (output, aux, failed), until ``deadline`` (perf_counter seconds) or for
    ``batches_per_client`` batches each; with ``serial``, one batch at a
    time, every thread staying until all are done. ``run_job`` is the
    default engine module's where none is given."""
    from quantum_computations_tpu_torch.pipelines.common import run_engines

    if run_job is None:
        run_job = _default_engine().run_job

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
            out, aux, failed = run_job(engine, job)
            recorder.stop()
            scores = score(job, out)
            end = time.perf_counter()
            with lock:
                done.append(Batch(job, clients[id(engine)], out, aux, tape, scores, failed,
                                  start, end))

    if len(engines) == 1:
        work(engines[0])
    else:
        run_engines(work, engines, errors)
    return done
