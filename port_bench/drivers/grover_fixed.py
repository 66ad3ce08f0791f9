"""Grover client: one fixed circuit (the traffic's tagged pair), transpiled
once, and a fresh batch seed per batch from the traffic's generator, as
``pipelines/grover_batched``'s work loop runs it; each trajectory is scored
by the raw weight of the tagged states."""

from __future__ import annotations

import numpy as np

from port_bench.drivers.common import Job, initial_coeffs, port_circuit
from port_bench.harness.circuits import grover


def make_client(config: dict, traffic: dict, rng: np.random.Generator):
    """(next_job, score) of this traffic."""
    N = int(config["qubits"])
    coeffs = initial_coeffs(config["initial"])
    gates = grover(traffic["tagged"])
    circuit = port_circuit(gates, N)
    tagged = list(traffic["tagged"])

    def next_job() -> Job:
        return Job(gates, N, coeffs, int(traffic["batch"]), int(rng.integers(2**31)), circuit)

    def score(job: Job, rho: np.ndarray) -> list[float]:
        return [float(np.sum(np.diag(r).real[tagged])) for r in rho]

    return next_job, score
