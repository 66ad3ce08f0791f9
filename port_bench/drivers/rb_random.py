"""Randomised benchmarking client: every batch the next random two-qubit
Clifford circuit of the traffic's depth and a fresh batch seed, as
``pipelines/rb_batched``'s work loop draws them; each trajectory is scored
by its fidelity to the exact DV state.

The circuits are ``random_circ``'s draws, its whole mix of gates, from a
generator seeded by the traffic's ``circuit_seed``: every run takes the
same stream of circuits in the same order, so its work does not depend on
its seed. The batch seeds, and so every homodyne outcome and range-finder
sketch, come from the run's ``--seed``."""

from __future__ import annotations

import numpy as np

from port_bench.drivers.common import Job, initial_coeffs, port_circuit
from port_bench.harness.circuits import random_clifford

_S2 = 2 ** -0.5
_MATRICES = {
    "I": np.eye(2), "H": np.array([[_S2, _S2], [_S2, -_S2]]),
    "P": np.diag([1, 1j]), "Pdg": np.diag([1, -1j]),
    "CZ": np.diag([1, 1, 1, -1]),
    "SWAP": np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]),
}


def make_client(config: dict, traffic: dict, rng: np.random.Generator):
    """(next_job, score) of this traffic."""
    N = int(config["qubits"])
    coeffs = initial_coeffs(config["initial"])
    circuits = np.random.default_rng(int(traffic["circuit_seed"]))

    def next_job() -> Job:
        gates = random_clifford(N, int(traffic["depth"]), circuits)
        seed = int(rng.integers(2**31))
        return Job(gates, N, coeffs, int(traffic["batch"]), seed, port_circuit(gates, N))

    return next_job, score


def dv_state(gates, N: int) -> np.ndarray:
    """The exact state of a DV gate list from |0...0>."""
    psi = np.zeros(2**N, dtype=np.complex128)
    psi[0] = 1.0
    for name, idx in gates:
        U = np.asarray(_MATRICES[name], np.complex128)
        idx = list(idx)
        perm = idx + [i for i in range(N) if i not in idx]
        t = np.transpose(psi.reshape([2] * N), perm).reshape(2 ** len(idx), -1)
        t = (U @ t).reshape([2] * N)
        psi = np.transpose(t, np.argsort(perm)).reshape(-1)
    return psi


def score(job: Job, rho: np.ndarray) -> list[float]:
    psi = dv_state(job.gates, job.N)
    return [float(np.real(np.conj(psi) @ r @ psi)) for r in rho]
