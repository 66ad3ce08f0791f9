"""Quantum-volume client: every job the next circuit of a fixed stream of
quantum-volume model circuits (arXiv:1811.12926) at the configuration's
width and the traffic's depth, drawn by the benchmark's reference
(``reference/statevector.quantum_volume``) from a generator seeded by the
traffic's ``circuit_seed``: every run does the same work in the same order,
whatever its seed. The run's ``--seed`` draws each job's seed, and from it
the logical basis states whose amplitudes are read out and the sampler's
seed. A circuit is scored by 2^N times the mean |amplitude|^2 at those
states, which reads about 1 for a normalised state."""

import dataclasses

import numpy as np

from port_bench.reference.statevector import quantum_volume


# (no ``from __future__ import annotations``: the harness loads a driver
# without registering it in sys.modules, where a dataclass looks up string
# annotations)
@dataclasses.dataclass
class Job:
    """One circuit (``engines/sv_slab``)."""

    gates: list            # [(4x4 complex128 matrix, (q_a, q_b))] in gate order
    N: int
    batch: int             # circuits in the job: always 1
    seed: int              # the job's seed: amplitude indices and sampling
    indices: np.ndarray    # (amplitudes,) int64 logical basis states to read
    shots: int


def make_client(config: dict, traffic: dict, rng: np.random.Generator):
    """(next_job, score) of this traffic."""
    N = int(config["qubits"])
    depth, shots, amplitudes = (int(traffic[k]) for k in ("depth", "shots", "amplitudes"))
    if int(traffic.get("batch", 1)) != 1:
        raise ValueError("a quantum-volume job is one circuit: the traffic's batch must be 1")
    circuits = np.random.default_rng(int(traffic["circuit_seed"]))

    def next_job() -> Job:
        gates = quantum_volume(N, depth, circuits)
        seed = int(rng.integers(2**31))
        indices = np.random.default_rng(seed).integers(1 << N, size=amplitudes, dtype=np.int64)
        return Job(gates, N, 1, seed, indices, shots)

    def score(job: Job, amps: np.ndarray) -> list[float]:
        return [float(2**job.N * np.mean(np.abs(amps.astype(np.complex128)) ** 2))]

    return next_job, score
