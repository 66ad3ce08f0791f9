"""GKP logical readout and squeezing-unit helpers (counterpart of
``quantum_computations_tpu/gkp/utils.py``).

dB <-> epsilon conversions, the decomposition of a homodyne outcome in
units of sqrt(pi), the syndrome-correction operator, and the logical
density matrix of an N-mode GKP MPS (Shaw et al., arXiv:2403.02396
App. D). The readout builds one (4, chi^2, chi^2) transfer tensor per mode
and sweeps the chain once: O(N chi^4 d), not O(4^N N chi^4 d).

The grid-sampled Pauli measurement operators are formed in float64 on the
host and cast to the state's dtype last: their cos(sqrt(pi) m q) phases
reach hundreds of radians on a [-20, 20] grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import full_fp32_matmul, to_device
from ..cv.mps import MPS, tensor_svd
from ..dv import qop

PI = np.pi
SQPI = np.sqrt(np.pi)


def eps2db(epsilon: float) -> float:
    return -10.0 * np.log10(2.0 * np.tanh(np.asarray(epsilon) / 2.0))


def db2eps(db_squeezing: float) -> float:
    return 2.0 * np.arctanh(np.float_power(10.0, -np.asarray(db_squeezing) / 10.0) / 2.0)


def decomp_result(s):
    """n, r such that s = (n + r) sqrt(pi)."""
    n = np.round(np.asarray(s) / SQPI).astype(int)
    r = np.asarray(s) / SQPI - n
    return n, r


def format_result(s, dec: int = 4) -> str:
    n, r = decomp_result(float(s) * 2**0.5)
    return f"({n}{r:+.{dec}f})√π"


def cv2dv_information(s) -> bool:
    """Parity of the closest multiple of sqrt(pi)."""
    return bool(np.round(float(s) / SQPI) % 2 == 1)


def syndrome_matrix(syndromes: list[tuple[int, int]]) -> torch.Tensor:
    """Pauli correction operator ⨂_i X^x Z^z for syndrome bits (x, z), a
    float64 CPU tensor."""
    ms = []
    for x, z in syndromes:
        m = np.identity(2)
        if x:
            m = qop.X @ m
        if z:
            m = qop.Z @ m
        ms.append(m)
    return qop.tensor(*ms)


def pauli_measurement_operators(qs: np.ndarray) -> np.ndarray:
    """Grid-sampled GKP Pauli measurement operators [I, X, Y, Z], stacked
    (4, d, d) complex128 on the host (Shaw et al. operator sums)."""
    qs = np.asarray(qs, dtype=np.float64)
    d = len(qs)
    dq = (qs[-1] - qs[0]) / d  # the reference's convention
    q_diff = qs[:, None] - qs[None, :]

    Xm = np.zeros((d, d))
    zdiag = np.zeros(d)
    max_m = int((qs[-1] - qs[0]) / SQPI) + 1
    for n, m in enumerate(range(1, max_m, 2)):
        coeff = (-1) ** (n % 2) * 2 / (m * PI)
        # sinc-interpolated displacement by ±m sqrt(pi)
        Xm += coeff * (np.sinc((q_diff - m * SQPI) / dq) + np.sinc((q_diff + m * SQPI) / dq))
        # the linear phases combined into a cosine diagonal
        zdiag += coeff * 2 * np.cos(SQPI * m * qs)
    Ym = 1j * Xm * zdiag[None, :]  # i Xm @ diag(zdiag)
    return np.stack([np.identity(d), Xm, Ym, np.diag(zdiag)]).astype(np.complex128)


_LOGICAL_PAULIS = np.stack([
    np.array([[1, 0], [0, 1]], dtype=complex),
    np.array([[0, 1], [1, 0]], dtype=complex),
    np.array([[0, -1j], [1j, 0]], dtype=complex),
    np.array([[1, 0], [0, -1]], dtype=complex),
])


@full_fp32_matmul()
def logical_density_batch(tensors, qs) -> torch.Tensor:
    """Logical density matrices (B, 2^N, 2^N) of a batch of N-mode GKP
    chains, tensors (B, l, d, r) on the grid ``qs``, in their dtype on
    their device; not normalised."""
    qs = np.asarray(qs)
    dq = (qs[-1] - qs[0]) / len(qs)  # the reference's convention
    like = tensors[0]
    Pms = to_device(pauli_measurement_operators(qs), like.device).to(like.dtype)

    N = len(tensors)
    B = like.shape[0]
    # C has axes (batch, p_1, ..., p_k, e), e the flattened (i, j) bond pair
    C = like.new_ones((B, 1))
    for m in tensors:
        a, b = m.shape[1], m.shape[3]
        # E[p, (a b), (i j)] = sum_{c,d'} m[a,c,i] conj(m)[b,d',j] Pms[p,d',c]
        tmp = torch.einsum("zaci,pdc->zpadi", m, Pms)
        E = torch.einsum("zpadi,zbdj->zpabij", tmp, m.conj()).reshape(B, 4, a * a, b * b)
        C = torch.einsum("z...e,zpef->z...pf", C, E)
    C = C.reshape((B,) + (4,) * N) * (dq / 2) ** N

    # rho = sum_p C[p] kron_k Ps[p_k]
    Ps = to_device(_LOGICAL_PAULIS, like.device).to(like.dtype)
    rho = C
    for _ in range(N):
        rho = torch.einsum("zp...,pij->z...ij", rho, Ps)
    # axes (batch, i_1, j_1, ..., i_N, j_N) -> (B, 2^N, 2^N)
    perm = [0] + list(range(1, 2 * N + 1, 2)) + list(range(2, 2 * N + 1, 2))
    return rho.permute(perm).reshape(B, 2**N, 2**N)


def full_logical_density_mps(mps: MPS, normalised: bool = False) -> torch.Tensor:
    """Logical density matrix (2^N, 2^N) of an N-mode GKP MPS, in the
    MPS's dtype on its device."""
    rho = logical_density_batch([t[None] for t in mps.tensors], mps.domain)[0]
    if normalised:
        rho = rho / torch.trace(rho)
    return rho


def full_logical_density(qs, state, normalised: bool = False) -> torch.Tensor:
    """Dense-grid variant: SVD-factorise the dense N-mode state (a tensor,
    whose device and dtype the MPS takes) into an MPS first."""
    state = torch.as_tensor(state)
    tensors = []
    state = state.reshape(1, *state.shape, 1)
    while state.ndim > 3:
        m, state, _ = tensor_svd(state, (0, 1), tuple(range(2, state.ndim)))
        tensors.append(m)
    tensors.append(state)
    return full_logical_density_mps(MPS(qs, tensors), normalised=normalised)
