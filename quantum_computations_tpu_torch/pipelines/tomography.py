"""Quantum process tomography with stacked operator bases (counterpart of
``quantum_computations_tpu/pipelines/tomography.py``).

Operator and state bases are stacked arrays (``(n, d, d)`` / ``(n, d)``).
The Pauli basis is Frobenius-orthonormal, so ``{E_m (.) E_n^dagger}`` is an
orthonormal basis of superoperator space and chi is a projection of the
least-squares superoperator, one einsum. The eager entry point
(:func:`process_tomography`) and its sampling-rank, CP and TP checks run in
float64 numpy, as in the JAX package; the JAX package's jitted kernels
(:func:`fit_superoperator`, :func:`chi_from_superoperator`,
:func:`kraus_from_chi`) are torch functions in complex128 on an explicit
``device`` (default ``cuda``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import resolve_device
from ..dv import qop

Channel = callable


# ---------------------------------------------------------------------------
# bases (stacked arrays)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def pauli_basis(N: int) -> np.ndarray:
    """Frobenius-orthonormal N-qubit Pauli basis, stacked ``(4^N, 2^N, 2^N)``
    (complex128 numpy; the device functions below take it as it is).

    tr(E_m^dagger E_n) = delta_mn; ordering matches the reference's
    ``itertools.product`` over (I, X, Y, Z)/sqrt(2) per qubit.
    """
    single = np.stack([np.asarray(p, dtype=np.complex128)
                       for p in (qop.IDTY, qop.X, qop.Y, qop.Z)]) / np.sqrt(2.0)
    basis = single
    for _ in range(N - 1):
        # kron of every pair: (m, a, b) x (4, c, d) -> (m*4, a*c, b*d)
        m, a, b = basis.shape
        basis = np.einsum("mab,ncd->mnacbd", basis, single).reshape(
            m * 4, a * 2, b * 2)
    basis.setflags(write=False)
    return basis


def computational_kets(N: int) -> np.ndarray:
    """All 2^N computational basis kets, stacked: the identity's rows."""
    return np.eye(2 ** N, dtype=np.complex128)


def probe_kets(N: int) -> np.ndarray:
    """Informationally complete pure probes, stacked ``(d^2, d)``:
    |n>, (|n>+|m>)/sqrt2 and (|n>+i|m>)/sqrt2 for n < m
    (reference ``pure_state_basis_kets``, tomography.py:52-63)."""
    d = 2 ** N
    eye = np.eye(d, dtype=complex)
    probes = [eye[i] for i in range(d)]
    iu, ju = np.triu_indices(d, k=1)
    for n, m in zip(iu, ju):
        probes.append((eye[n] + eye[m]) / np.sqrt(2))
        probes.append((eye[n] + 1j * eye[m]) / np.sqrt(2))
    return np.stack(probes)


# Reference-compatible list-of-matrices views (reference tomography.py:44-71).
def state_basis(N: int) -> list[np.ndarray]:
    kets = np.asarray(computational_kets(N))
    return [np.outer(n, m) for n in kets for m in kets]


def pure_state_basis_kets(N: int) -> list[np.ndarray]:
    return list(np.asarray(probe_kets(N)))


def operator_basis(N: int) -> list[np.ndarray]:
    return list(np.asarray(pauli_basis(N)))


# ---------------------------------------------------------------------------
# device core (torch, on an explicit device)
# ---------------------------------------------------------------------------

def _on(x, device) -> torch.Tensor:
    """A host array or tensor as complex128 on ``device`` (default ``cuda``)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.complex128))
    return t.to(device=resolve_device(device), dtype=torch.complex128)


def fit_superoperator(inputs, outputs, *, device=None) -> torch.Tensor:
    """Least-squares M with vec(out_i) = M vec(in_i) for stacked density
    matrices ``(n, d, d)``, complex128 on ``device``. Returns ``(d^2, d^2)``."""
    inputs, outputs = _on(inputs, device), _on(outputs, device)
    n = inputs.shape[0]
    A = inputs.reshape(n, -1).T     # (d^2, n)
    B = outputs.reshape(n, -1).T
    return B @ torch.linalg.pinv(A)


def chi_from_superoperator(M, basis, *, device=None) -> torch.Tensor:
    """Project the superoperator onto the orthonormal {E_m . E_n^dagger}
    frame: chi[m, n] = sum_{rcab} E_m^*[r,a] M[(r,c),(a,b)] E_n[c,b]."""
    M, basis = _on(M, device), _on(basis, device)
    d = basis.shape[-1]
    M4 = M.reshape(d, d, d, d)
    return torch.einsum("mra,rcab,ncb->mn", basis.conj(), M4, basis)


def kraus_from_chi(chi, basis, *, device=None):
    """Diagonalise chi; columns give Kraus operators in the Pauli frame.
    Returns (eigenvalues ascending, stacked operators ``(4^N, d, d)``)."""
    chi, basis = _on(chi, device), _on(basis, device)
    D, U = torch.linalg.eigh(chi)
    Ks = torch.einsum("km,kab->mab", U, basis)
    return D, Ks


# ---------------------------------------------------------------------------
# channels and the eager entry point
# ---------------------------------------------------------------------------

def quantum_channel(Ks, *, ket_input: bool = False, return_input: bool = False,
                    normalise: bool = False):
    """Channel rho -> sum_i w_i K_i rho K_i^dagger from Kraus operators.

    ``Ks`` is a list of operators or a ``(weights, operators)`` tuple
    (reference tomography.py:14-41)."""
    if isinstance(Ks, tuple) and len(Ks) == 2 and isinstance(Ks[1], list):
        weights, ops = Ks
    else:
        weights, ops = [1.0] * len(Ks), Ks
    stack = np.stack([np.asarray(K) for K in ops]).astype(complex)
    w = np.asarray(weights, dtype=complex)

    def apply(rho):
        out = np.einsum("k,kab,bc,kdc->ad", w, stack, np.asarray(rho),
                        stack.conj(), optimize=True)
        if normalise:
            out = out / np.trace(out)
        return (rho, out) if return_input else out

    if ket_input:
        return lambda ket: apply(np.outer(np.asarray(ket),
                                          np.conj(np.asarray(ket))))
    return apply


def process_matrix(inputs, outputs) -> np.ndarray:
    """Least-squares superoperator with an explicit sampling-rank check
    (reference raises on under-sampled probe sets, tomography.py:95-99)."""
    if len(inputs) != len(outputs):
        raise ValueError("Inconsistent number of inputs to outputs.")
    A = np.stack([np.asarray(r).reshape(-1) for r in inputs]).T
    S = np.linalg.svd(A, compute_uv=False)
    cutoff = max(A.shape) * np.finfo(A.dtype).eps * S.max()
    if int((S > cutoff).sum()) < A.shape[1]:
        raise ValueError("Insufficiently sampled input set.")
    B = np.stack([np.asarray(r).reshape(-1) for r in outputs]).T
    return B @ np.linalg.pinv(A)


def chi_matrix(process_mat, N: int, *, strict: bool = False) -> np.ndarray:
    basis = np.asarray(pauli_basis(N), dtype=complex)
    d = basis.shape[-1]
    M4 = np.asarray(process_mat, dtype=complex).reshape(d, d, d, d)
    chi = np.einsum("mra,rcab,ncb->mn", basis.conj(), M4, basis, optimize=True)
    if strict:
        if not np.allclose(chi, chi.conj().T):
            raise ValueError("Chi matrix not completely positive (CP)")
        # TP <=> sum_mn chi[m,n] E_n^dagger E_m = I
        test = np.einsum("mn,nba,mbc->ac", chi, np.asarray(basis).conj(),
                         np.asarray(basis), optimize=True)
        if not np.allclose(test, np.identity(test.shape[0])):
            raise ValueError("Chi matrix not trace preserving (TP)")
    return chi


def kraus_operators(chi, N: int):
    basis = np.asarray(pauli_basis(N), dtype=complex)
    D, U = np.linalg.eigh(np.asarray(chi, dtype=complex))
    Ks = np.einsum("km,kab->mab", U, basis)
    return D, [K for K in Ks]


# Spelling alias for reference parity (the reference spells it "krauss").
krauss_operators = kraus_operators


def eval_process(process, N: int, ket_input: bool):
    """Drive ``process`` over the probe set; returns (inputs, outputs) as
    lists of density matrices."""
    probes = np.asarray(probe_kets(N))
    inputs, outputs = [], []
    for ket in probes:
        arg = ket if ket_input else np.outer(ket, ket.conj())
        inp, out = process(arg)
        inputs.append(np.asarray(inp))
        outputs.append(np.asarray(out))
    return inputs, outputs


def process_tomography(process, N: int, *, ket_input: bool = True,
                       normalised: bool = False, full_output: bool = False,
                       strict: bool = False, cutoff: float = 1e-12):
    """Kraus operators {K_i} with process(rho) = sum K_i rho K_i^dagger
    (reference tomography.py:187-215)."""
    M = process_matrix(*eval_process(process, N, ket_input))
    chi = chi_matrix(M, N, strict=strict)
    if not np.allclose(chi, chi.conj().T):
        raise ValueError("Process is not a CPTP map!")
    D, Ks = kraus_operators(chi, N)
    if not full_output:
        keep = D > cutoff
        D = D[keep]
        Ks = [K for K, f in zip(Ks, keep) if f]
    if normalised:
        return D, Ks
    return [np.sqrt(d) * K for d, K in zip(D, Ks)]
