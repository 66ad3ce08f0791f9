"""Truncated SVD split of the plain reference.

Frozen copy of ``quantum_computations_tpu_torch/ops/linalg.py`` at commit
6cc9e90 (the Gram SVD, the eigh and Newton-Schulz inverse square roots,
the Halko range finder, the truncation rule and the batched split), with
the port's per-call matmul precision taken out and the range finder's
Gaussian sketches handed in: one (n, l) float64 matrix per trajectory,
the sketch the timed run drew for that trajectory.
"""

from __future__ import annotations

import torch

OVERSAMPLE = 10


def _trace(G: torch.Tensor) -> torch.Tensor:
    return G.diagonal(dim1=-2, dim2=-1).sum(-1)


def svd_gram(A: torch.Tensor):
    """Thin SVD from the float64 Gram eigendecomposition on the smaller
    side (with the port's 1e-15 diagonal ramp)."""
    m, n = A.shape[-2:]
    if m < n:
        U, s, Vh = svd_gram(A.mH)
        return Vh.mH.resolve_conj(), s, U.mH.resolve_conj()
    A64 = A.to(torch.complex128 if A.is_complex() else torch.float64)
    G = A64.mH @ A64
    G.diagonal(dim1=-2, dim2=-1).add_(
        torch.arange(n, dtype=torch.float64, device=G.device)
        * (1e-15 * _trace(G).real / n**2)[..., None])
    w, V = torch.linalg.eigh(G)
    w, V = w.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = (A64 @ V) / torch.where(s > 0, s, torch.ones_like(s))[..., None, :]
    return U.to(A.dtype), s.to(A.real.dtype), V.mH.resolve_conj().to(A.dtype)


def svd(A: torch.Tensor):
    """LAPACK on the CPU, the Gram route on CUDA (the port's dispatch)."""
    if A.is_cuda:
        return svd_gram(A)
    return torch.linalg.svd(A, full_matrices=False)


def bucket(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def hermitian_inv_sqrt(G: torch.Tensor, eps_rel: float = 1e-12) -> torch.Tensor:
    w, V = torch.linalg.eigh(G.to(torch.complex128 if G.is_complex() else torch.float64))
    floor = w.amax(-1, keepdim=True) * eps_rel
    inv_sqrt_w = torch.where(w > floor, torch.maximum(w, floor).rsqrt(), torch.zeros_like(w))
    return ((V * inv_sqrt_w.to(V.dtype)[..., None, :]) @ V.mH).to(G.dtype)


def ns_inv_sqrt(G: torch.Tensor, iters: int = 24, ridge: float = 1e-7) -> torch.Tensor:
    """Coupled Newton-Schulz G^(-1/2) of G / tr(G) + ridge I."""
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    t = (_trace(G).real + 1e-30)[..., None, None]
    Y, Z = G / t + ridge * eye, eye
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Z / torch.sqrt(t)


def orthonormalize(Y: torch.Tensor) -> torch.Tensor:
    """Complex128 Gram inverse square root by eigh, then one Newton-Schulz
    polish."""
    Y64 = Y.to(torch.complex128 if Y.is_complex() else torch.float64)
    Q = (Y64 @ hermitian_inv_sqrt(Y64.mH @ Y64)).to(Y.dtype)
    G2 = Q.mH @ Q
    eye = torch.eye(G2.shape[-1], dtype=G2.dtype, device=G2.device)
    return Q @ (1.5 * eye - 0.5 * G2)


def randomized_truncated_svd(A: torch.Tensor, k: int, sketches):
    """Rank-k Halko SVD of each matrix of a batch with the given sketches
    (a wide matrix is transposed first; q = 7 power iterations if
    k < 0.1 min(shape), else 4)."""
    shape = A.shape[-2:]
    q = 7 if k < 0.1 * min(shape) else 4
    transpose = shape[0] < shape[1]
    if transpose:
        A = A.mT
    l = min(k + OVERSAMPLE, min(shape))
    O = torch.stack([s.to(device=A.device) for s in sketches]).to(A.dtype)
    O = O.reshape(*A.shape[:-2], A.shape[-1], l)
    Q = orthonormalize(A @ O)
    for _ in range(q):
        Q1 = orthonormalize(A.mH @ Q)
        Q = orthonormalize(A @ Q1)
    U, s, Vh = svd(Q.mH @ A)
    U, s, Vh = Q @ U[..., :k], s[..., :k], Vh[..., :k, :]
    if transpose:
        return Vh.mT, s, U.mT
    return U, s, Vh


def truncation_rank_mask(s: torch.Tensor, max_bond_dim: int, rel_err: float):
    """Keep the smallest r whose dropped tail sums to at most rel_err sum(s),
    r <= max_bond_dim (abs_err is 0 in every configuration here)."""
    allowed = torch.clamp(torch.sum(s, -1, keepdim=True) * rel_err, min=0.0)
    tail = s.flip(-1).cumsum(-1).flip(-1)
    keep = (tail > allowed) & (torch.arange(s.shape[-1], device=s.device) < max_bond_dim)
    return keep.to(s.dtype)


def split_pair(res: torch.Tensor, max_bond_dim: int, rel_err: float, sketches):
    """Split a batch of (a, d, d, b) tensors across (a, d | d, b) at the
    capacity min(bucket(mbd), mbd), truncated directions zero-masked.
    ``sketches`` is None for the exact SVD, else one per trajectory."""
    B, a, d1, d2, b = res.shape
    m = res.reshape(B, a * d1, d2 * b)
    full_rank = min(m.shape[-2:])
    mbd = min(max_bond_dim, full_rank)
    cap = min(bucket(mbd), mbd)
    if mbd * 10 < full_rank:
        if sketches is None:
            raise ValueError("a randomized split needs its sketches")
        u, s, vh = randomized_truncated_svd(m, min(cap, full_rank), sketches)
    else:
        u, s, vh = svd(m)
    mask = truncation_rank_mask(s, mbd, rel_err)
    gap = cut_gap(s, mask)
    sqrt_s = (torch.sqrt(s) * mask).to(u.dtype)
    m1 = u * sqrt_s[..., None, :]
    m2 = sqrt_s[..., :, None] * vh
    k_have = m1.shape[-1]
    if k_have < cap:
        m1 = torch.cat([m1, m1.new_zeros(*m1.shape[:-1], cap - k_have)], -1)
        m2 = torch.cat([m2, m2.new_zeros(*m2.shape[:-2], cap - k_have, m2.shape[-1])], -2)
    elif k_have > cap:
        m1, m2 = m1[..., :cap], m2[..., :cap, :]
    return m1.reshape(B, a, d1, cap), m2.reshape(B, cap, d2, b), gap


def cut_gap(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per matrix, (s_last_kept - s_first_dropped) / s_last_kept: near 0
    where the truncation cuts a (near-)degenerate pair of singular values,
    and the kept direction within the pair is fixed by rounding alone; 1
    where nothing is dropped."""
    r = mask.sum(-1).long()
    n = s.shape[-1]
    last = torch.take_along_dim(s, (r - 1).clamp(min=0)[..., None], -1)[..., 0]
    first = torch.take_along_dim(s, r.clamp(max=n - 1)[..., None], -1)[..., 0]
    gap = (last - first) / torch.clamp(last, min=torch.finfo(s.dtype).tiny)
    return torch.where(r < n, gap, torch.ones_like(gap))

