"""Average Clifford-encoding fidelity (counterpart of
``quantum_computations_tpu/pipelines/clifford_fidelity.py``).

Direct GKP-MPS encoding of an N-qubit ket with one bond index per nonzero
amplitude, the 16 phase-free two-qubit Paulis, a breadth-first search of
the Cayley graph of the two-qubit Clifford generators (720 symplectic
classes, diameter 7), and the per-(dB, class) job writing the
``gkp_cliff.dat`` schema {db, clifford_index, fidelities[16]}. The
encoding and the logical readout run on ``device`` (default ``cuda``); the
class search is host numpy.
"""

from __future__ import annotations

import dataclasses
from itertools import product as iprod

import numpy as np
import torch

from ..config import complex_dtype, resolve_device
from ..cv.mps import MPS
from ..cv.states import State, eval_gkp_state
from ..dv import qop
from ..gkp import db2eps, full_logical_density_mps
from .common import config_cli, prepare_output, write_data


def encode_ket(qs: np.ndarray, epsilon: float, ket: np.ndarray, *, device=None,
               dtype=None) -> MPS:
    """GKP-MPS encoding of a normalised N-qubit ket: one bond index per
    nonzero computational-basis amplitude. The wavefunctions are formed in
    complex128 on ``device`` (default ``cuda``) and the MPS takes ``dtype``
    (default the device's complex dtype)."""
    ket = np.asarray(ket)
    ket = ket / np.linalg.norm(ket)
    N = qop.num_qubits(ket)
    device = resolve_device(device)
    dtype = dtype or complex_dtype(device)

    if N == 1:
        state = eval_gkp_state(qs, epsilon, tuple(ket), device=device,
                               dtype=torch.complex128)
        return MPS(qs, [state.reshape(1, -1, 1)], dtype=dtype)

    basis_states: list[list[State]] = []
    coeffs: list[complex] = []
    for i, coeff in enumerate(ket):
        if np.isclose(np.abs(coeff), 0):
            continue
        binary = "{0:0{1}b}".format(i, N)
        basis_states.append(
            [State.GKP_ZERO if digit == "0" else State.GKP_ONE for digit in binary]
        )
        coeffs.append(complex(coeff))

    M = len(basis_states)
    wf = {s: s.eval(qs, epsilon, device=device, dtype=torch.complex128)
          for s in (State.GKP_ZERO, State.GKP_ONE)}
    d = len(qs)

    def site(i):  # (d, M): column j is basis state j's wavefunction at mode i
        return torch.stack([wf[bs[i]] for bs in basis_states], -1)

    c = torch.tensor(coeffs, dtype=torch.complex128, device=device)
    eye = torch.eye(M, dtype=torch.complex128, device=device)
    tensors = [(site(0) * c)[None]]
    for i in range(1, N - 1):
        tensors.append(eye[:, None, :] * site(i)[None])
    tensors.append(site(N - 1).T.reshape(M, d, 1))
    return MPS(qs, tensors, dtype=dtype)


def compute_paulis() -> list[np.ndarray]:
    """16 phase-free two-qubit Paulis X^u Z^v ⊗ X^u Z^v."""
    paulis = []
    for u1, v1, u2, v2 in iprod([0, 1], repeat=4):
        P1 = (qop.X if u1 else qop.IDTY) @ (qop.Z if v1 else qop.IDTY)
        P2 = (qop.X if u2 else qop.IDTY) @ (qop.Z if v2 else qop.IDTY)
        paulis.append(np.kron(P1, P2))
    return paulis


def pauli_symplectic_label(P, paulis):
    for idx, (u1, v1, u2, v2) in enumerate(iprod([0, 1], repeat=4)):
        candidate = paulis[idx]
        i, j = np.argwhere(np.abs(candidate) > 1e-8)[0]
        c = P[i, j] / candidate[i, j]
        if np.allclose(P, candidate * c):
            return (u1, u2, v1, v2)
    raise ValueError("Not a Pauli operator!")


def symplectic_rep(U, paulis):
    basis = [
        np.kron(qop.X, qop.IDTY), np.kron(qop.IDTY, qop.X),
        np.kron(qop.Z, qop.IDTY), np.kron(qop.IDTY, qop.Z),
    ]
    M = np.zeros((4, 4), dtype=int)
    for col, P in enumerate(basis):
        M[:, col] = pauli_symplectic_label(U @ P @ U.conj().T, paulis)
    return M % 2


def compute_cliffords(verbose: bool = False) -> list[np.ndarray]:
    """BFS over the Cayley graph of 2-qubit Clifford generators.

    Returns one unitary representative per symplectic equivalence class
    (720 classes, diameter 7 for this generator set), in the JAX package's
    order.
    """
    paulis = compute_paulis()
    cx_flipped = qop.permute_tensor_product(qop.CX, [1, 0]).numpy()
    generators = [
        np.kron(qop.H, qop.IDTY), np.kron(qop.IDTY, qop.H),
        np.kron(qop.P, qop.IDTY), np.kron(qop.IDTY, qop.P),
        qop.CX, cx_flipped, qop.SWAP,
    ]
    generators_sympl = [(symplectic_rep(g, paulis), g) for g in generators]

    def key(arr):
        return tuple(map(tuple, arr))

    idty = np.eye(4, dtype=int)
    hashmap = {key(idty): (idty.astype(complex), 0)}
    queue = [idty]
    while queue:
        S = queue.pop(0)
        U, dist = hashmap[key(S)]
        for Sg, Ug in generators_sympl:
            S_new = (Sg @ S) % 2
            k = key(S_new)
            if k not in hashmap:
                hashmap[k] = (Ug @ U, dist + 1)
                queue.append(S_new)
            elif hashmap[k][1] > dist + 1:
                hashmap[k] = (Ug @ U, dist + 1)

    reps = [unitary for unitary, _ in hashmap.values()]
    if verbose:
        print("Enumerated symplectic reps:", len(reps))  # 720
        print("Full coverage depth (Cayley graph diameter):",
              max(d for _, d in hashmap.values()))  # 7
    return reps


def job(qs: np.ndarray, db: float, clifford: np.ndarray, clifford_idx: int,
        paulis: list[np.ndarray], *, device=None, dtype=None) -> dict:
    """Encoding fidelities <P C|00>|rho|P C|00>> of one class at one dB, for
    the 16 Paulis P, with rho the normalised logical density of the GKP
    encoding of C|00> (on ``device``, one fetch)."""
    ket = clifford @ np.array([1.0, 0, 0, 0])
    mps = encode_ket(qs, float(db2eps(db)), ket, device=device, dtype=dtype)
    rho = full_logical_density_mps(mps, normalised=True)
    kets = torch.from_numpy(np.stack([p @ ket for p in paulis]).astype(np.complex128))
    kets = kets.to(device=rho.device, dtype=rho.dtype)
    fids = torch.einsum("ka,ab,kb->k", kets.conj(), rho, kets).real
    return {"db": float(db), "clifford_index": clifford_idx,
            "fidelities": [float(f) for f in fids.cpu()]}


@dataclasses.dataclass
class CliffordConfig:
    """Clifford-encoding fidelity sweep (gkp_cliff.dat schema)."""

    db_min: float = 5.0
    db_max: float = 15.0
    db_points: int = 13
    db_take: int = 2            # reference: linspace(...)[:2]
    grid_points: int = 1000
    grid_span: float = 20.0
    num_cliffords: int = 0      # 0 = all 720
    data_file: str = "gkp_cliff.dat"
    overwrite: bool = False
    write_every: int = 50
    device: str = "cuda"


def main(config: CliffordConfig | None = None, progress: bool = True):
    config = config or CliffordConfig()
    dbs = np.linspace(config.db_min, config.db_max, config.db_points)[: config.db_take]
    qs = np.linspace(-config.grid_span, config.grid_span, config.grid_points)
    cliffords = compute_cliffords(verbose=progress)
    if config.num_cliffords:
        cliffords = cliffords[: config.num_cliffords]
    paulis = compute_paulis()

    prepare_output(config.data_file, config.overwrite)
    args = list(iprod(dbs, range(len(cliffords))))
    iterator = args
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(args, smoothing=0.0)
        except ImportError:
            pass

    data = []
    for db, idx in iterator:
        data.append(job(qs, db, cliffords[idx], idx, paulis, device=config.device))
        if config.data_file and len(data) % config.write_every == 0:
            write_data(config.data_file, data)
    if config.data_file:
        write_data(config.data_file, data)
    return data


if __name__ == "__main__":
    main(config_cli(CliffordConfig))
