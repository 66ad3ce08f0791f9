"""Truncated SVD with capped bond dimensions (counterpart of
``quantum_computations_tpu/ops/linalg.py``).

``tensor_svd`` returns factors padded to a fixed capacity, with truncated
singular directions zero-masked; :func:`trim_split` then slices them down
to the (bucketed) kept rank, which it reads on the host: one device sync
per split, as in the JAX engine's eager mode.

Every function takes leading batch axes (one matrix per trajectory of
the batched GKP engine) as well as a single matrix; whatever depends on
a matrix's values (traces, eigenvalue floors, kept ranks) is taken per
matrix.

The thin SVD (:func:`svd_compat`) dispatches by device, as the JAX
package's does: ``torch.linalg.svd`` (LAPACK) on the CPU, and on CUDA
:func:`svd_gram`, the Hermitian eigendecomposition of the Gram matrix on
the smaller side in float64. Every Gram eigendecomposition here goes
through :func:`_eigh`: on CUDA, a batch of at least ``KERNEL_MIN_BATCH``
Grams of side 33 to 128 (the range finder's and the randomized split's at
the production bond cap) to the one-launch Jacobi kernel
(:mod:`.herm_eigh_small`), which neither loops over the batch nor waits
for the device (its convergence is checked at the engine's next
:func:`fetch`); a smaller batch, a smaller or larger Gram and every CPU
one to ``torch.linalg.eigh`` (cuSOLVER, one call per matrix above side 32
and an info check that waits; LAPACK on the CPU). On an H100,
cuSOLVER's complex64 SVD of a (10^5, 10^3) two-mode split kept its
truncated part with a 2e-2 relative error against LAPACK's complex128 SVD
(the float64 Gram route: 1.4e-7) and took 4.6 s (the Gram route: 46 ms);
the Gram route is accurate to float32 input precision for every direction
above 1e-6 of the largest singular value. The JAX package's
realified-Gram ``svd_via_eigh`` is a TPU route and has no counterpart
here.
"""

from __future__ import annotations

import math
import threading

import torch

from ..config import full_fp32_matmul, to_device
from ..utils.profiling import span
from ..utils.rng import draw_rows
from . import herm_eigh_small as _small

# Fixed oversampling for the randomized SVD.
OVERSAMPLE = 10


# The Gram batches the kernel takes: sides KERNEL_MIN_SIDE..MAX_N, at least
# KERNEL_MIN_BATCH matrices. Elsewhere cuSOLVER was the faster on an H100
# (PERF.md's kernel table): at side <= 32 torch's route is itself one
# batched Jacobi launch, and above it, below 3 matrices, its one call per
# matrix beats the kernel, whose time is one matrix's ~10^3 dependent
# sub-rounds whatever the batch.
KERNEL_MIN_SIDE = 33
KERNEL_MIN_BATCH = 3

# Per thread: the least ``info`` of the kernel's launches since the host
# last looked (a device scalar), or None; :func:`fetch` reads it.
_unchecked = threading.local()


def _eigh(G: torch.Tensor):
    """(w ascending, V) of a Hermitian float64 or complex128 batch: on CUDA
    at sides ``KERNEL_MIN_SIDE`` to ``herm_eigh_small.MAX_N`` and at least
    ``KERNEL_MIN_BATCH`` matrices, one launch of the batched Jacobi kernel (span
    ``linalg:eigh_small``: a launch, no wait), else ``torch.linalg.eigh``
    (span ``linalg:eigh``: cuSOLVER's call and its info-check wait, or
    LAPACK on the CPU).

    A matrix the kernel did not converge on gets NaN in ``w`` and ``V``,
    and the next :func:`fetch` on this thread raises, as cuSOLVER's info
    check would have."""
    n = G.shape[-1]
    if (G.is_cuda and KERNEL_MIN_SIDE <= n <= _small.MAX_N
            and G.numel() >= KERNEL_MIN_BATCH * n * n):
        with span("linalg:eigh_small"):
            w, V, info = _small.herm_eigh_small(G)
            failed = (info < 0)[..., None]
            w = w.masked_fill(failed, math.nan)
            V = V.masked_fill(failed[..., None], math.nan)
            least = getattr(_unchecked, "info", None)
            info = info.amin()
            _unchecked.info = (info if least is None
                               else torch.minimum(least, info.to(least.device)))
        return w, V
    with span("linalg:eigh"):
        return torch.linalg.eigh(G)


def fetch(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied to the host. The same copy carries the least ``info``
    of this thread's eigensolver kernel launches since the last fetch, and
    raises ``torch.linalg.LinAlgError`` if one of them did not converge."""
    least = getattr(_unchecked, "info", None)
    if least is None or not x.is_cuda:
        return x.cpu()
    _unchecked.info = None
    both = torch.cat([x.reshape(-1), least.to(x.device, x.dtype).reshape(1)]).cpu()
    if both[-1] < 0:
        raise torch.linalg.LinAlgError(
            "herm_eigh_small: a Gram eigendecomposition did not converge "
            f"within {_small.MAX_SWEEPS} sweeps or held a non-finite entry")
    return both[:-1].reshape(x.shape)


@full_fp32_matmul()
def svd_gram(A: torch.Tensor):
    """Thin SVD of A from the eigendecomposition of its Gram matrix on the
    smaller side, formed and decomposed in float64 whatever A's dtype.

    s_i = sqrt(max(lambda_i, 0)) is accurate to ~1e-16 s_max^2 / s_i, and
    U = A V / s, so U s V^H = A V V^H reconstructs A on the kept directions
    however small their s. Returns (U, s, Vh) in A's dtype, s descending.

    The Gram's diagonal gets a ramp i * 1e-15 * mean(lambda) / n, below its
    own float64 rounding: on an H100, cuSOLVER's eigh failed to converge on
    the Gram of a rank-deficient two-mode split of a three-mode circuit
    without it.
    """
    m, n = A.shape[-2:]
    if m < n:
        U, s, Vh = svd_gram(A.mH)
        return Vh.mH.resolve_conj(), s, U.mH.resolve_conj()
    A64 = A.to(torch.complex128 if A.is_complex() else torch.float64)
    G = A64.mH @ A64
    G.diagonal(dim1=-2, dim2=-1).add_(
        torch.arange(n, dtype=torch.float64, device=G.device)
        * (1e-15 * _trace(G).real / n**2)[..., None])
    w, V = _eigh(G)  # ascending
    w, V = w.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = (A64 @ V) / torch.where(s > 0, s, torch.ones_like(s))[..., None, :]
    return U.to(A.dtype), s.to(A.real.dtype), V.mH.resolve_conj().to(A.dtype)


def _trace(G: torch.Tensor) -> torch.Tensor:
    """The trace of each matrix of a batch."""
    return G.diagonal(dim1=-2, dim2=-1).sum(-1)



def svd_compat(A: torch.Tensor, full_matrices: bool = False):
    """Thin SVD: ``torch.linalg.svd`` on the CPU, :func:`svd_gram` on CUDA."""
    assert not full_matrices
    if A.is_cuda:
        return svd_gram(A)
    return torch.linalg.svd(A, full_matrices=False)


def bucket(n: int) -> int:
    """Round a bond capacity up to a power of two."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def trim_split(m1: torch.Tensor, m2: torch.Tensor, rank):
    """Slice a zero-padded SVD split down to its (bucketed) true rank.

    Truncated directions are exact zeros, so slicing them away is lossless.
    Reading ``rank`` on the host (:func:`fetch`) is one device sync. m1's LAST axis and
    m2's FIRST axis are the shared bond.
    """
    r = bucket(max(1, int(fetch(torch.as_tensor(rank)))))
    if r < m1.shape[-1]:
        m1 = m1[..., :r]
        m2 = m2[:r, ...]
    return m1, m2


@full_fp32_matmul()
def _hermitian_inv_sqrt(G: torch.Tensor, eps_rel: float = 1e-12) -> torch.Tensor:
    """G^{-1/2} for a small Hermitian PSD matrix by :func:`_eigh` in
    float64 (complex eigh directly; the JAX package realifies for its TPU).
    Eigenvalues at or below ``max(w) * eps_rel`` are dropped."""
    G64 = G.to(torch.complex128 if G.is_complex() else torch.float64)
    w, V = _eigh(G64)
    floor = w.amax(-1, keepdim=True) * eps_rel
    inv_sqrt_w = torch.where(w > floor, torch.maximum(w, floor).rsqrt(),
                             torch.zeros_like(w))
    return ((V * inv_sqrt_w.to(V.dtype)[..., None, :]) @ V.mH).to(G.dtype)


@full_fp32_matmul()
def _ns_inv_sqrt(G: torch.Tensor, iters: int = 24, ridge: float = 1e-7) -> torch.Tensor:
    """G^{-1/2} for a small Hermitian PSD matrix by the coupled
    Newton–Schulz iteration: matmuls only, no eigendecomposition and no
    host sync. A = G/tr(G) + ridge I has its spectrum in (0, 1]; then
    T = (3I - Z Y)/2, Y <- Y T, Z <- T Z converges with Z -> A^{-1/2}."""
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    t = (_trace(G).real + 1e-30)[..., None, None]
    Y, Z = G / t + ridge * eye, eye
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Z / torch.sqrt(t)


@full_fp32_matmul()
def orthonormalize(Y: torch.Tensor, *, method: str = "eigh") -> torch.Tensor:
    """Tall-skinny orthonormalization: Gram inverse-sqrt, then one
    Newton–Schulz polish Q = Q0 (3I - Q0^H Q0)/2.

    ``method="eigh"`` takes the inverse square root from a float64 eigh
    (one host sync), with the Gram and Q0 formed in complex128 whatever
    Y's dtype: a complex64 Gram is off by ~1e-7 of its largest eigenvalue,
    so in the weak directions that the 1e-12 floor keeps, Q0 would not be
    orthonormal. ``method="ns"`` runs two passes of the matmul-only
    :func:`_ns_inv_sqrt` instead (the streamed split's choice: no sync);
    its ridge damps the weak directions rather than amplifying them.
    """
    if method == "ns":
        Q = Y
        for _ in range(2):
            Q = Q @ _ns_inv_sqrt(Q.mH @ Q)
    else:
        Y64 = Y.to(torch.complex128 if Y.is_complex() else torch.float64)
        Q = (Y64 @ _hermitian_inv_sqrt(Y64.mH @ Y64)).to(Y.dtype)
    G2 = Q.mH @ Q
    eye = torch.eye(G2.shape[-1], dtype=G2.dtype, device=G2.device)
    return Q @ (1.5 * eye - 0.5 * G2)


def _gaussian_sketch(n: int, l: int, generator: torch.Generator | None,
                     like: torch.Tensor) -> torch.Tensor:
    """A real Gaussian (n, l) sketch drawn in float64 on the generator's
    device, then cast and moved to ``like``'s dtype and device: one
    generator state gives the same sketch for every dtype and device."""
    if generator is None:
        raise ValueError("randomized SVD requires a torch.Generator")
    o = torch.randn((n, l), generator=generator, dtype=torch.float64,
                    device=generator.device)
    return to_device(o, like.device).to(like.dtype)


@full_fp32_matmul()
def randomized_range_finder(A: torch.Tensor, l: int, q: int,
                            generator: torch.Generator | None = None, *,
                            sketch=None) -> torch.Tensor:
    """Find Q (n x l) with Q Q^H A ~= A via Gaussian sketch + q power
    iterations. ``sketch`` (an (A.shape[-1], l) real array, per matrix of
    a batch) replaces the draw from ``generator``; a batch draws one
    sketch per matrix, in order (:func:`..utils.rng.draw_rows`)."""
    with span("linalg:sketch"):
        if sketch is not None:
            O = torch.as_tensor(sketch).to(device=A.device, dtype=A.dtype)
        elif A.ndim == 2:
            O = _gaussian_sketch(A.shape[1], l, generator, A)
        else:
            O = torch.stack(draw_rows(
                generator, math.prod(A.shape[:-2]),
                lambda _: _gaussian_sketch(A.shape[-1], l, generator, A)))
            O = O.reshape(*A.shape[:-2], A.shape[-1], l)
    Q = orthonormalize(A @ O)
    for _ in range(q):
        Q1 = orthonormalize(A.mH @ Q)
        Q = orthonormalize(A @ Q1)
    return Q


@full_fp32_matmul()
def randomized_truncated_svd(A: torch.Tensor, k: int,
                             generator: torch.Generator | None = None, *,
                             sketch=None):
    """Rank-k randomized SVD (Halko). Returns (U, s, Vh) with k columns/rows.

    q = 7 power iterations if k < 0.1 * min(shape), else 4; a wide matrix
    is transposed first, so the sketch has min(shape) rows.
    """
    shape = A.shape[-2:]
    q = 7 if k < 0.1 * min(shape) else 4
    transpose = shape[0] < shape[1]
    if transpose:
        A = A.mT
    Q = randomized_range_finder(A, min(k + OVERSAMPLE, min(shape)), q,
                                generator, sketch=sketch)
    U, s, Vh = svd_compat(Q.mH @ A, full_matrices=False)
    U, s, Vh = Q @ U[..., :k], s[..., :k], Vh[..., :k, :]
    if transpose:
        return Vh.mT, s, U.mT
    return U, s, Vh


def truncation_rank_mask(s: torch.Tensor, max_bond_dim: int, abs_err: float,
                         rel_err: float):
    """Number of singular values to keep and the {0,1} keep-mask.

    Keep the smallest r such that the dropped tail sums to at most
    max(abs_err, sum(s) * rel_err), and r <= max_bond_dim. The rank stays on
    the device (one per spectrum of a batch).
    """
    allowed = torch.clamp(torch.sum(s, -1, keepdim=True) * rel_err, min=abs_err)
    tail = s.flip(-1).cumsum(-1).flip(-1)  # tail[i] = s[i] + s[i+1] + ...
    keep = (tail > allowed) & (torch.arange(s.shape[-1], device=s.device)
                               < max_bond_dim)
    return keep.sum(-1), keep.to(s.dtype)


def matrix_svd_split(m: torch.Tensor, cap: int, *, max_bond_dim: int,
                     abs_err: float, rel_err: float,
                     generator: torch.Generator | None = None,
                     use_randomized: bool | None = None):
    """SVD-split m ~= m1 @ m2 with internal dimension `cap`.

    m1: (..., m.shape[-2], cap), m2: (..., cap, m.shape[-1]); truncated
    directions are zeroed. The randomized path is chosen when
    ``max_bond_dim * 10 < full_rank`` unless overridden. Returns
    (m1, m2, rank), the rank a device tensor (one per matrix of a batch).
    """
    full_rank = min(m.shape[-2:])
    if use_randomized is None:
        use_randomized = max_bond_dim * 10 < full_rank
    if use_randomized:
        if generator is None:
            raise ValueError("randomized SVD requires a torch.Generator")
        u, s, vh = randomized_truncated_svd(m, min(cap, full_rank), generator)
    else:
        u, s, vh = svd_compat(m, full_matrices=False)

    rank, mask = truncation_rank_mask(s, max_bond_dim, abs_err, rel_err)
    sqrt_s = (torch.sqrt(s) * mask).to(u.dtype)
    m1 = u * sqrt_s[..., None, :]
    m2 = sqrt_s[..., :, None] * vh

    k_have = m1.shape[-1]
    if k_have < cap:
        m1 = torch.cat([m1, m1.new_zeros(*m1.shape[:-1], cap - k_have)], -1)
        m2 = torch.cat([m2, m2.new_zeros(*m2.shape[:-2], cap - k_have,
                                         m2.shape[-1])], -2)
    elif k_have > cap:
        m1 = m1[..., :cap]
        m2 = m2[..., :cap, :]
    return m1, m2, rank


def tensor_svd(tensor: torch.Tensor, left_indices, right_indices, *,
               max_bond_dim: int | None = None, abs_err: float = 0.0,
               rel_err: float = 1e-12,
               generator: torch.Generator | None = None,
               cap: int | None = None, svd_method: str = "auto",
               batch_dims: int = 0):
    """Split a rank-n tensor across (left_indices | right_indices) by SVD.

    Returns (m1, m2, rank): m1 owns left_indices + [bond], m2 owns
    [bond] + right_indices, with the bond padded to the capacity
    ``min(bucket(mbd), mbd)`` for a given ``max_bond_dim`` (else
    ``bucket(full_rank)``) unless `cap` is given. The first
    ``batch_dims`` axes are a batch of tensors, each split on its own (the
    indices count the axes after them); ``rank`` then has the batch's
    shape.
    """
    left_indices = list(left_indices)
    right_indices = list(right_indices)
    if sorted(left_indices + right_indices) != list(range(tensor.ndim - batch_dims)):
        raise IndexError("Output indices does not match indices of initial tensor")

    batch = list(tensor.shape[:batch_dims])
    lshape = [tensor.shape[batch_dims + i] for i in left_indices]
    rshape = [tensor.shape[batch_dims + i] for i in right_indices]
    m = tensor.permute(list(range(batch_dims))
                       + [batch_dims + i for i in left_indices + right_indices])
    m = m.reshape(*batch, math.prod(lshape), math.prod(rshape))

    full_rank = min(m.shape[-2:])
    mbd = full_rank if max_bond_dim is None else min(max_bond_dim, full_rank)
    if cap is None:
        cap = min(bucket(mbd), mbd) if max_bond_dim is not None else bucket(mbd)
    if svd_method == "full":
        use_randomized = False
    elif svd_method == "randomized":
        use_randomized = True
    else:
        use_randomized = None if max_bond_dim is not None else False
    m1, m2, rank = matrix_svd_split(
        m, cap, max_bond_dim=mbd, abs_err=abs_err, rel_err=rel_err,
        generator=generator, use_randomized=use_randomized,
    )
    return (m1.reshape(*batch, *lshape, cap), m2.reshape(*batch, cap, *rshape),
            rank)
