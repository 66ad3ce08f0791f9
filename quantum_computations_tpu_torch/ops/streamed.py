"""Streamed two-mode contraction + transform + randomized SVD (counterpart
of ``quantum_computations_tpu/ops/streamed.py``).

A two-mode CV gate contracts its neighbours into A[a, i, j, b] =
W(t1 . t2), W a grid transform of :func:`..ops.interp.affine_warp`, and
splits the (a d, d b) matrix. Above ``cv.gates._STREAM_THRESHOLD`` that
matrix does not fit in memory (10^10 elements at d = 1000, bond cap 100),
so this module computes its randomized SVD without forming it: every
product of the subspace iteration (A O and A^H Q) is recomputed from t1
and t2. The CZ phase factors through the bond, so its sweeps are three
dense products whose largest intermediate is a (k, d, l) sliver
(:func:`_cz_sweep_fns`); every other transform streams over row blocks of
at most ``_BLOCK_ELEMENTS`` elements (:func:`_sweep_fns`). A BS rotation
and a CX shear split once through their warp; ``_BS_DECOMP = "cz"`` runs
them as Fourier-conjugated CZ splits instead, as the JAX package does by
default.

Per split: the Fourier pre-gates, a Gaussian sketch, ``power_iters``
rounds plus one final round of (orthonormalize, A-sweep, orthonormalize,
A^H-sweep) with the matmul-only ``orthonormalize(method="ns")``, the
(l x l) Gram of the last sweep formed in complex128, ONE fetch of it to
the host (the only device sync), a float64 numpy eigh with the reference
truncation rule, and the assembly of the factors with the Fourier
post-gates. The kept rank is a host int.
:func:`streamed_pair_svd_batched` runs a batch of trajectories' splits one
after another (one Gram fetch each), where the JAX package's vmapped
programs fetch one batch of Grams.

Differences from the JAX package, all deliberate: the direct BS route by
default and no ``QCT_BS_DECOMP``; one layout with Python loops (the JAX
package's traced layout, program caches and device-eigh mode exist for
XLA's compile budget on its TPU); every round at full FP32 on the card (no
bf16 sketch rounds, no ``QCT_STREAM_FINAL_PREC``) and in complex128 on the
CPU; the Gram in complex128 on every device; the CZ phase table formed in
float64 and cast last.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import full_fp32_matmul, to_device
from ..utils.profiling import span
from ..utils.rng import draw_rows
from .interp import affine_warp, fourier
from .linalg import OVERSAMPLE, orthonormalize

# Target row-block footprint of the block-streamed sweeps: elements of the
# transformed (ac d, d bc) block.
_BLOCK_ELEMENTS = 1 << 25

# How a BS rotation or a CX shear splits: "rot", one split through the
# block-streamed warp; "cz", three (BS) or one (CX) Fourier-conjugated CZ
# splits. The BS's three truncations keep other ranks than one split and
# its kept s^2 miss the direct split's criterion, so "rot" is the default
# here (the JAX package defaults to "cz" for its TPU's FFT cost); "cz" is
# kept for parity with the JAX package and for measurement.
_BS_DECOMP = "rot"

# Power iterations of a streamed split: q = 2 unless QCT_STREAM_POWER_ITERS
# pins an integer or "ref" (the reference heuristic the call site passes).
_POWER_ITERS_ENV = os.environ.get("QCT_STREAM_POWER_ITERS")
_DEFAULT_POWER_ITERS = 2


def effective_power_iters(q: int) -> int:
    """The power-iteration count of a streamed split; ``q`` is the
    reference heuristic (7 or 4) the call site computed."""
    if _POWER_ITERS_ENV:
        if _POWER_ITERS_ENV == "ref":
            return q
        return int(_POWER_ITERS_ENV)
    return _DEFAULT_POWER_ITERS


def _divisors_desc(n: int):
    return [x for x in range(n, 0, -1) if n % x == 0]


def _pick_chunks(a: int, d: int, b: int, budget: int | None = None) -> tuple[int, int]:
    """(ac, bc): divisors of a and b with ac*d*d*bc <= budget (default
    ``_BLOCK_ELEMENTS``, read at call time). The grid axes stay whole (the
    FFT shears need them); b is kept whole as long as possible."""
    if budget is None:
        budget = _BLOCK_ELEMENTS
    for bc in _divisors_desc(b):
        for ac in _divisors_desc(a):
            if ac * d * d * bc <= budget:
                return ac, bc
    return 1, 1


def _sweep_fns(qs, warp_params, shapes, chunks, dtype):
    """Block-streamed A@O and A^H@Q for any warp. Columns are (grid j,
    bond b), j-major, so a b-chunk is a strided column set of a (d, b, l)
    factor."""
    a, d, k, b = shapes
    ac, bc = chunks
    n_a, n_b = a // ac, b // bc

    def block(t1, t2, ci, bi):
        """The transformed (ac d, d bc) block of rows ci and columns bi."""
        t1c = t1[ci * ac:(ci + 1) * ac]
        t2c = t2[:, :, bi * bc:(bi + 1) * bc]
        Tc = torch.einsum("aik,kjb->aijb", t1c, t2c)
        return affine_warp(qs, Tc, warp_params).to(dtype).reshape(ac * d, d * bc)

    def matmul_A(t1, t2, O3):
        """A @ O: O3 (d, b, l) -> (a d, l)."""
        Y = O3.new_zeros((a * d, O3.shape[2]))
        for ci in range(n_a):
            for bi in range(n_b):
                Oc = O3[:, bi * bc:(bi + 1) * bc].reshape(d * bc, -1)
                Y[ci * ac * d:(ci + 1) * ac * d] += block(t1, t2, ci, bi) @ Oc
        return Y

    def matmul_AH(t1, t2, Q):
        """A^H @ Q: Q (a d, l) -> (d, b, l)."""
        Z3 = Q.new_zeros((d, b, Q.shape[1]))
        for ci in range(n_a):
            Qc = Q[ci * ac * d:(ci + 1) * ac * d]
            for bi in range(n_b):
                Z3[:, bi * bc:(bi + 1) * bc] += (
                    block(t1, t2, ci, bi).mH @ Qc).reshape(d, bc, -1)
        return Z3

    return matmul_A, matmul_AH


def _cz_sweep_fns(qs, gain, shapes, dtype):
    """A@O and A^H@Q of the CZ phase warp, factored through the bond.

    A[(a,i),(j,b)] = P[i,j] sum_k t1[a,i,k] t2[k,j,b] with P = exp(i g q q^T),
    so (A O)[a,i,l] = sum_k t1[a,i,k] (P @ (t2 . O))[k,i,l]: one dense
    (d x d) @ (d x k l) product between two bond contractions, every
    intermediate a (k, d, l) sliver. P is formed in float64 and cast."""
    a, d, k, b = shapes
    q64 = torch.as_tensor(qs, dtype=torch.float64)
    P = torch.exp(1j * gain * torch.outer(q64, q64)).to(dtype)

    def matmul_A(t1, t2, O3):
        W1 = torch.einsum("kjb,jbl->kjl", t2, O3)
        V = torch.einsum("ij,kjl->kil", P, W1)
        return torch.einsum("aik,kil->ail", t1, V).reshape(a * d, -1)

    def matmul_AH(t1, t2, Q):
        U1 = torch.einsum("aik,ail->ikl", t1.conj(), Q.reshape(a, d, -1))
        U2 = torch.einsum("ij,ikl->jkl", P.conj(), U1)
        return torch.einsum("kjb,jkl->jbl", t2.conj(), U2)

    return matmul_A, matmul_AH


def _stream_sketch(d: int, b: int, l: int, generator: torch.Generator | None,
                   like: torch.Tensor) -> torch.Tensor:
    """The (d, b, l) real Gaussian sketch of one streamed split, drawn in
    float64 on the generator's device, then cast and moved to ``like``'s
    dtype and device: one generator state gives the same sketch for every
    dtype and device."""
    if generator is None:
        raise ValueError("a streamed split requires a torch.Generator")
    o = torch.randn((d, b, l), generator=generator, dtype=torch.float64,
                    device=generator.device)
    return to_device(o, like.device).to(like.dtype)


def _gram(Xm: torch.Tensor) -> torch.Tensor:
    """B B^H = Xm^H Xm, formed in complex128 whatever Xm's dtype: a
    complex64 Gram resolves singular values only down to ~3e-4 s_max."""
    X64 = Xm.to(torch.complex128)
    return X64.mH @ X64


def _host_factor(G: np.ndarray, cap: int, mbd: int, abs_err: float, rel_err: float):
    """Eigendecomposition + truncation of the (l x l) Gram on the host.

    Returns (U (l, cap), sqrt(s) * mask, mask / sqrt(s), rank) with the
    reference truncation rule (keep the smallest r whose dropped tail sums
    to at most max(abs_err, rel_err * sum(s)), r <= mbd) on the capped
    spectrum s = sqrt(eigenvalues)."""
    w, U = np.linalg.eigh((G + G.T.conj()) / 2.0)
    w = np.clip(w[::-1], 0.0, None)
    U = U[:, ::-1]
    s = np.sqrt(w)[:cap]
    U = U[:, :cap]
    allowed = max(abs_err, s.sum() * rel_err)
    tail = np.cumsum(s[::-1])[::-1]
    keep = (tail > allowed) & (np.arange(s.shape[0]) < mbd)
    rank = int(keep.sum())
    mask = keep.astype(np.float64)
    sq = np.sqrt(s)
    sqm = sq * mask
    ism = np.where(s > 0, mask / np.where(s > 0, sq, 1.0), 0.0)
    return U, sqm, ism, rank


@full_fp32_matmul()
def _streamed_driver(t1, t2, qs, warp_params, *, max_bond_dim, abs_err,
                     rel_err, generator, power_iters,
                     f_pre=(None, None), f_post=(None, None)):
    """One streamed split of affine_warp(t1 . t2, warp_params).

    ``f_pre``/``f_post`` are the Fourier gates on modes 1 and 2 around it
    (True = inverse, False = forward, None = none)."""
    a, d, k = t1.shape
    b = t2.shape[-1]
    rows, cols = a * d, d * b
    cap = min(max_bond_dim, rows, cols)
    l = min(cap + OVERSAMPLE, rows, cols)
    dtype = t1.dtype
    if warp_params[0] == "cz":
        mm_A, mm_AH = _cz_sweep_fns(qs, float(warp_params[1]), (a, d, k, b), dtype)
    else:
        mm_A, mm_AH = _sweep_fns(qs, warp_params, (a, d, k, b),
                                 _pick_chunks(a, d, b), dtype)

    with span("streamed:iterate"):
        if f_pre[0] is not None:
            t1 = fourier(qs, t1, axis=1, inv=f_pre[0])
        if f_pre[1] is not None:
            t2 = fourier(qs, t2, axis=1, inv=f_pre[1])
        # X_0 = Omega; Q_t = orth(A orth(X_t)); X_{t+1} = A^H Q_t. After the
        # q power rounds and the final round, Q spans range((A A^H)^q A
        # Omega) and B = Q^H A = X^H.
        X = _stream_sketch(d, b, l, generator, t1)
        for _ in range(power_iters + 1):
            Xo = orthonormalize(X.reshape(cols, l), method="ns").reshape(d, b, l)
            Q = orthonormalize(mm_A(t1, t2, Xo), method="ns")
            X = mm_AH(t1, t2, Q)
        Xm = X.reshape(cols, l)
        G = _gram(Xm)
    with span("streamed:gram_fetch"):
        G = G.cpu().numpy()
    if not np.isfinite(G).all():
        raise FloatingPointError(
            f"the streamed split of {a}x{d}x{d}x{b} elements ({warp_params}) "
            "produced a non-finite Gram")
    with span("streamed:host_eigh"):
        U, sqm, ism, rank = _host_factor(G, cap, int(max_bond_dim), abs_err, rel_err)
    with span("streamed:assemble"):
        # m1 = (Q U) diag(sqm); m2 = diag(ism) (Xm U)^H, since B = Xm^H and
        # Vh = diag(1/s) U^H B
        real = t1.real.dtype
        U = torch.from_numpy(np.ascontiguousarray(U)).to(t1.device, dtype)
        sqm = torch.from_numpy(sqm).to(t1.device, real)
        ism = torch.from_numpy(ism).to(t1.device, real)
        m1 = ((Q @ U) * sqm[None, :]).reshape(a, d, cap)
        m2 = (ism[:, None] * (Xm @ U).mH).reshape(cap, d, b)
        if f_post[0] is not None:
            m1 = fourier(qs, m1, axis=1, inv=f_post[0])
        if f_post[1] is not None:
            m2 = fourier(qs, m2, axis=1, inv=f_post[1])
    return m1, m2, rank


# A BS rotation as three Fourier-conjugated CZ splits (rotation by three
# shears, each shear a CZ between Fourier gates):
#     BS(theta) = CXa(tan(theta/2)) CXb(-sin(theta)) CXa(tan(theta/2)),
#     CXa(g) = F1 . exp(i g x1 x2) . F1^-1,
# applied rightmost first as
#     F1^-1 | cz(t) | F1 | F2^-1 | cz(m) | F2 | F1^-1 | cz(t) | F1,
# with t = tan(angle/2), m = -sin(angle); each split absorbs the Fourier
# gates around it (f_pre / f_post).

def _streamed_rot_via_cz(t1, t2, qs, angle, **kw):
    """Streamed BS(angle) split as three CZ splits."""
    t_g = float(np.tan(angle / 2.0))
    m_g = float(-np.sin(angle))
    m1, m2, _ = _streamed_driver(t1, t2, qs, ("cz", t_g), f_pre=(True, None),
                                 f_post=(False, True), **kw)
    m1, m2, _ = _streamed_driver(m1, m2, qs, ("cz", m_g), f_pre=(None, None),
                                 f_post=(True, False), **kw)
    return _streamed_driver(m1, m2, qs, ("cz", t_g), f_pre=(None, None),
                            f_post=(False, None), **kw)


def _streamed_shear_via_cz(t1, t2, qs, gain, control_left, **kw):
    """Streamed CX split as one CZ split: ("shear", g, True) =
    F2 . cz(-g) . F2^-1; ("shear", g, False) mirrors it on mode 1."""
    if control_left:
        f_pre, f_post = (None, True), (None, False)
    else:
        f_pre, f_post = (True, None), (False, None)
    return _streamed_driver(t1, t2, qs, ("cz", -float(gain)), f_pre=f_pre,
                            f_post=f_post, **kw)


def streamed_pair_svd(t1: torch.Tensor, t2: torch.Tensor, qs: torch.Tensor,
                      warp_params: tuple, *, max_bond_dim: int, abs_err: float,
                      rel_err: float, generator: torch.Generator | None,
                      power_iters: int = 4):
    """SVD-split of affine_warp(t1 . t2, warp_params) viewed as an
    (a d, d b) matrix, without forming it.

    t1: (a, d, k), t2: (k, d, b), qs: the float64 grid on their device.
    Returns (m1 (a, d, cap), m2 (cap, d, b), rank) with the truncation of
    :func:`..linalg.tensor_svd` (truncated directions zero-masked, cap =
    min(max_bond_dim, a d, d b)); ``rank`` is a host int. The sketches are
    drawn from ``generator``, one per CZ or direct split.
    """
    kw = dict(max_bond_dim=max_bond_dim, abs_err=abs_err, rel_err=rel_err,
              generator=generator, power_iters=power_iters)
    if _BS_DECOMP == "cz":
        if warp_params[0] == "rot":
            return _streamed_rot_via_cz(t1, t2, qs, float(warp_params[1]), **kw)
        if warp_params[0] == "shear":
            return _streamed_shear_via_cz(t1, t2, qs, warp_params[1],
                                          warp_params[2], **kw)
    return _streamed_driver(t1, t2, qs, warp_params, **kw)


def streamed_pair_svd_batched(t1: torch.Tensor, t2: torch.Tensor, qs: torch.Tensor,
                              warp_params: tuple, *, max_bond_dim: int,
                              abs_err: float, rel_err: float,
                              generator: torch.Generator | None,
                              power_iters: int = 4):
    """Batched :func:`streamed_pair_svd`: t1 (B, a, d, k), t2 (B, k, d, b).

    Returns (m1 (B, a, d, cap), m2 (B, cap, d, b), rank): the factors at
    the common cap min(max_bond_dim, a d, d b), each trajectory's truncated
    directions zero-masked, and the kept ranks as a host int array (B,).
    The trajectories split one after another (one Gram fetch each),
    drawing their sketches from ``generator`` in order
    (:func:`..utils.rng.draw_rows`).
    """
    kw = dict(max_bond_dim=max_bond_dim, abs_err=abs_err, rel_err=rel_err,
              generator=generator, power_iters=power_iters)
    # every split of a trajectory draws a (d, b, l) sketch: one split, or
    # three along the three-CZ route of a rotation
    _, a, d, _ = t1.shape
    b = t2.shape[-1]
    l = min(min(max_bond_dim, a * d, d * b) + OVERSAMPLE, a * d, d * b)
    splits = 3 if _BS_DECOMP == "cz" and warp_params[0] == "rot" else 1

    def skip():
        for _ in range(splits):
            _stream_sketch(d, b, l, generator, t1)

    out = draw_rows(generator, t1.shape[0],
                    lambda z: streamed_pair_svd(t1[z], t2[z], qs, warp_params, **kw),
                    skip)
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            np.asarray([o[2] for o in out], dtype=np.int64))
