"""The Hermitian eigendecomposition of a batch of small matrices in one
launch: :func:`herm_eigh_small` (the Hopper kernel ``csrc/herm_eigh_small.cu``
on CUDA tensors) and :func:`herm_eigh_small_plain` (the same algorithm in
plain PyTorch, for CPU tensors and as the kernel's reference).

Both keep ``torch.linalg.eigh``'s contract for a (..., n, n) Hermitian
batch, n <= :data:`MAX_N`: they read the lower triangle (the diagonal's
real part), and return ``w`` (..., n) float64 in ascending order and ``V``
(..., n, n) with ``G = V diag(w) V^H``, in complex128 (float64 for a real
input), plus ``info`` (...,) int32: the sweeps a matrix took, negative
(minus the cap) if it did not converge within :data:`MAX_SWEEPS` or holds
a non-finite entry (it then stops at once).

The algorithm is cyclic two-sided Jacobi in float64 with complex rotations
in a parallel ordering, the same in both versions. The matrix is padded to
m = 2 C k (zero rows and columns, which no rotation mixes) and its columns
are cut into 2 C blocks of k, held two to a "member" c < C (the kernel's
thread-block cluster has C blocks, one per member; block 2c on top, 2c + 1
at the bottom, at the start of every sweep). A sweep is 2 C - 1 block
rounds, and the blocks move between block rounds in the circle method, so
that every pair of blocks meets once. In each sub-round every member
rotates k disjoint pairs of its own 2 k columns: in the first block round a
round-robin over all 2 k (2 k - 1 sub-rounds), after it every top column
against every bottom one (k sub-rounds), m - 1 sub-rounds a sweep in all.
A rotation zeroes ``A[p, q]`` and sets ``A[p, p]``, ``A[q, q]`` to the
2 x 2 problem's eigenvalues; it applies ``A <- J^H A J`` and ``V <- V J``
with ``J = [[c, sigma], [-conj(sigma), c]]``; a pair whose ``|A[p, q]|``
is at most ``TOL ||A||_F / m`` is left alone. Within a block round a
member's own 2k x 2k block changes only by the member's own rotations, so
both versions run a block round's rotations on that block first and then
apply them to the rest. A matrix stops at the start of the first sweep at
which its off-diagonal Frobenius norm is at most :data:`TOL` times its
Frobenius norm. The eigenpairs are then sorted ascending, ties by column.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["herm_eigh_small", "herm_eigh_small_plain", "geometry", "load",
           "MAX_N", "MAX_SWEEPS", "TOL"]

MAX_N = 128        # the largest side the kernel takes
MAX_CLUSTER = 8    # thread blocks per matrix (the portable cluster size)
COLS_PER_MEMBER = 16  # columns a member holds, at most
MAX_SWEEPS = 40
TOL = 1e-15        # off(A) <= TOL * ||A||_F stops a matrix


def geometry(n: int) -> tuple[int, int, int]:
    """(C, k, m): members, columns per block, padded side m = 2 C k."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"side {n} outside 1..{MAX_N}")
    C = min(MAX_CLUSTER, -(-n // COLS_PER_MEMBER))
    k = -(-n // (2 * C))
    return C, k, 2 * C * k


def _local_pair(first: bool, t: int, i: int, k: int) -> tuple[int, int]:
    """Member slots of pair i in sub-round t (slots 0..k-1 top, k..2k-1
    bottom): the round-robin of the first block round, else top i against
    bottom (i + t) mod k. The kernel computes the same."""
    if first:
        L = 2 * k - 1
        if i == 0:
            return t, L
        return (t + i) % L, (t - i) % L
    return i, k + (i + t) % k


def _circle(top: list, bot: list) -> tuple[list, list]:
    """The circle method's turn: block 0 of member 0 stays, the others move
    one place (top of c to top of c + 1, the last top to the last bottom,
    bottom of c to bottom of c - 1, bottom of 0 to top of 1)."""
    ring = top[1:] + bot[::-1]
    ring = ring[-1:] + ring[:-1]
    C = len(top)
    return top[:1] + ring[:C - 1], ring[C - 1:][::-1]


def _block_rounds(n: int):
    """Per block round of a sweep: (first, the (C, 2k) member columns)."""
    C, k, _ = geometry(n)
    top, bot = [2 * c for c in range(C)], [2 * c + 1 for c in range(C)]
    rounds = []
    for br in range(2 * C - 1):
        cols = [[top[c] * k + j for j in range(k)] + [bot[c] * k + j for j in range(k)]
                for c in range(C)]
        rounds.append((br == 0, cols))
        top, bot = _circle(top, bot)
    return rounds


def _check(G: torch.Tensor) -> int:
    if G.dim() < 2 or G.shape[-1] != G.shape[-2]:
        raise ValueError(f"expected a (..., n, n) batch, got {tuple(G.shape)}")
    n = G.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"side {n} outside 1..{MAX_N}")
    if G.dtype not in (torch.complex128, torch.float64):
        raise TypeError(f"expected complex128 or float64, got {G.dtype}")
    return n


def _hermitian_from_lower(G: torch.Tensor) -> torch.Tensor:
    """The Hermitian matrix of G's lower triangle and real diagonal."""
    low = torch.tril(G, -1)
    return low + low.mH + torch.diag_embed(G.diagonal(dim1=-2, dim2=-1).real.to(G.dtype))


def _rotations(a, b, g, tau):
    """Per pair: (c, sigma, t h, rotated) of the 2 x 2 problem
    [[a, g], [conj g, b]], h = |g|: J^H [[a, g], [conj g, b]] J =
    diag(a - t h, b + t h). A pair with h <= tau is left alone (c = 1,
    sigma = 0, rotated False)."""
    h = g.abs()
    rotated = h > tau
    hs = torch.where(rotated, h, torch.ones_like(h))
    theta = (b - a) / (2 * hs)
    big = theta.abs() > 1e150
    theta_s = torch.where(big, torch.ones_like(theta), theta)
    sgn = torch.where(theta >= 0, 1.0, -1.0).to(theta.dtype)
    t = torch.where(big, 0.5 / torch.where(big, theta, torch.ones_like(theta)),
                    sgn / (theta_s.abs() + torch.sqrt(1 + theta_s * theta_s)))
    t = torch.where(rotated, t, torch.zeros_like(t))
    c = 1 / torch.sqrt(1 + t * t)
    sigma = (t * c).to(g.dtype) * torch.where(rotated, g / hs, torch.zeros_like(g))
    return c, sigma, t * h, rotated


@functools.lru_cache(maxsize=None)
def _local_pairs(first: bool, k: int) -> tuple[torch.Tensor, ...]:
    """Per sub-round of a block round, the (k, 2) own slot pairs."""
    return tuple(torch.tensor([_local_pair(first, t, i, k) for i in range(k)])
                 for t in range(2 * k - 1 if first else k))


def _local_sweep(Lb, U, first: bool, k: int, tau) -> None:
    """A block round's rotations on every member's own block, in place:
    ``Lb`` (B, C, 2k, 2k) the blocks A[own][own], ``U`` their accumulated
    unitaries (A[own][own] <- U^H A[own][own] U), ``tau`` (B, 1, 1)."""
    for pairs in _local_pairs(first, k):
        pairs = pairs.to(Lb.device)
        p, q = pairs[:, 0], pairs[:, 1]
        d = Lb.diagonal(dim1=-2, dim2=-1).real
        a, b = d[..., p], d[..., q]
        g = Lb[..., p, q]
        c, sigma, th, rotated = _rotations(a, b, g, tau)
        # J of the sub-round: [[c, sigma], [-conj(sigma), c]] on each pair
        J = torch.zeros_like(Lb)
        cz = c.to(Lb.dtype)
        J[..., p, p] = cz
        J[..., q, q] = cz
        J[..., p, q] = sigma
        J[..., q, p] = -sigma.conj()
        Lb.copy_(J.mH @ Lb @ J)
        U.copy_(U @ J)
        # a rotated pair's own block: its exact eigenvalues and zeros
        new_d = torch.zeros_like(Lb[..., 0, :])
        new_d[..., p] = torch.where(rotated, (a - th).to(Lb.dtype), Lb[..., p, p])
        new_d[..., q] = torch.where(rotated, (b + th).to(Lb.dtype), Lb[..., q, q])
        Lb.diagonal(dim1=-2, dim2=-1).copy_(new_d)
        Lb[..., p, q] = torch.where(rotated, 0, Lb[..., p, q])
        Lb[..., q, p] = torch.where(rotated, 0, Lb[..., q, p])


def _sweep(A: torch.Tensor, V: torch.Tensor, n: int, tau: torch.Tensor) -> None:
    """One sweep over a (B, m, m) batch, in place, block round by block
    round: every member runs its rotations on its own block (as the
    kernel's simulating threads do), and the block-diagonal product of
    the members' unitaries P is then applied at once, A <- P^H A P and
    V <- V P, with each member's own block taken from its run."""
    C, k, m = geometry(n)
    B, kk = A.shape[0], 2 * k
    for first, cols in _block_rounds(n):
        L = torch.tensor(cols, device=A.device).reshape(-1)  # member order
        X = A[:, L][:, :, L].reshape(B, C, kk, C, kk)
        idx = torch.arange(C, device=A.device)
        Lb = X[:, idx, :, idx, :].permute(1, 0, 2, 3).contiguous()  # (B, C, kk, kk)
        U = torch.eye(kk, dtype=A.dtype, device=A.device).expand(B, C, kk, kk).clone()
        _local_sweep(Lb, U, first, k, tau[:, None, None])
        Y = torch.einsum("bcxy,bcxdz,bdzw->bcydw", U.conj(), X, U)
        Y[:, idx, :, idx, :] = Lb.permute(1, 0, 2, 3)
        A[:, L[:, None], L[None, :]] = Y.reshape(B, m, m)
        V[:, :, L] = torch.einsum("brcx,bcxy->brcy", V[:, :, L].reshape(B, m, C, kk),
                                  U).reshape(B, m, m)


def _off_and_norm(A: torch.Tensor):
    """Squared off-diagonal and whole Frobenius norms, each summed on its
    own (their difference would cancel)."""
    sq = A.real ** 2 + A.imag ** 2
    diag = sq.diagonal(dim1=-2, dim2=-1)
    off = (sq - torch.diag_embed(diag)).sum((-2, -1))
    return off, off + diag.sum(-1)


def herm_eigh_small_plain(G: torch.Tensor):
    """:func:`herm_eigh_small`'s algorithm in plain PyTorch, on G's device:
    returns ``(w, V, info)``."""
    n = _check(G)
    real = not G.is_complex()
    batch = G.shape[:-2]
    H = _hermitian_from_lower(G.reshape(-1, n, n).to(torch.complex128))
    Bn = H.shape[0]
    _, _, m = geometry(n)
    A = torch.zeros(Bn, m, m, dtype=torch.complex128, device=G.device)
    A[:, :n, :n] = H
    V = torch.eye(m, dtype=torch.complex128, device=G.device).repeat(Bn, 1, 1)
    info = torch.full((Bn,), -MAX_SWEEPS, dtype=torch.int32)
    tau = None
    for sweep in range(MAX_SWEEPS + 1):
        off, total = _off_and_norm(A)
        if tau is None:  # a rotation below it cannot matter to the stop test
            tau = TOL * torch.sqrt(total) / m
        done = (off <= TOL * TOL * total).cpu() & (info < 0)
        info[done] = sweep
        # a non-finite matrix never converges: it stops at once, unconverged
        active = ((info < 0) & (total < float("inf")).cpu()).nonzero().flatten()
        if active.numel() == 0 or sweep == MAX_SWEEPS:
            break
        idx = active.to(G.device)
        A_act, V_act = A[idx], V[idx]
        _sweep(A_act, V_act, n, tau[idx])
        A[idx], V[idx] = A_act, V_act
    w = A.diagonal(dim1=-2, dim2=-1).real[:, :n]
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V[:, :n, :n], -1, order[:, None, :].expand(Bn, n, n))
    if real:
        V = V.real
    return (w.reshape(*batch, n), V.reshape(*batch, n, n),
            info.to(G.device).reshape(batch))


# -- the kernel --------------------------------------------------------------
@functools.cache
def _kernel():
    fn = _build.load("herm_eigh_small").qct_herm_eigh_small
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build (once per tree) and load the kernel's library, binding it."""
    _kernel()


def herm_eigh_small(G: torch.Tensor):
    """Eigendecomposition of a Hermitian (..., n, n) batch, n <= 128, as
    ``torch.linalg.eigh`` gives it, plus each matrix's sweeps: returns
    ``(w, V, info)`` (module docstring).

    CUDA: one launch of the Hopper kernel on PyTorch's current stream, no
    synchronisation (``info`` stays on the device). CPU:
    :func:`herm_eigh_small_plain`. Any other device raises.
    """
    n = _check(G)
    if G.device.type == "cpu":
        return herm_eigh_small_plain(G)
    if G.device.type != "cuda":
        raise ValueError(f"herm_eigh_small runs on cuda or cpu, not {G.device}")
    real = not G.is_complex()
    batch = G.shape[:-2]
    A = G.reshape(-1, n, n).to(torch.complex128).contiguous()
    Bn = A.shape[0]
    w = torch.empty(Bn, n, dtype=torch.float64, device=G.device)
    V = torch.empty(Bn, n, n, dtype=torch.complex128, device=G.device)
    info = torch.empty(Bn, dtype=torch.int32, device=G.device)
    if Bn:
        C, k, _ = geometry(n)
        with torch.cuda.device(G.device):
            stream = torch.cuda.current_stream(G.device).cuda_stream
            err = _kernel()(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                            info.data_ptr(), Bn, n, C, k, MAX_SWEEPS, TOL,
                            stream)
        if err != 0:
            raise RuntimeError(f"herm_eigh_small kernel launch failed: CUDA "
                               f"error {err} (B={Bn}, n={n})")
        herm_eigh_small.launches += 1
    if real:
        V = V.real
    return w.reshape(*batch, n), V.reshape(*batch, n, n), info.reshape(batch)


herm_eigh_small.launches = 0  # kernel launches, counted where they happen
