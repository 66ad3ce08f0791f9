"""Fused measurement-based gadgets without SVDs (counterpart of
``quantum_computations_tpu/ops/fused_gadget.py``).

:func:`fused_single_gadget` runs a whole single-mode teleportation gadget
(Bell splice, beamsplitter, both homodynes) on the virtual post-BS pair:
the Bell splice makes the pair an outer product, the BS is a point
rotation of the (q1, q2) plane, so the first homodyne's distribution is a
correlation of two 1-D line tabulations, and the collapse is one
Fourier-shifted line evaluation. :func:`fused_pair_measure2` does the same
for the macronode's last two beamsplitters, whose operands share a bond
(four paths, chosen by the homodyne angles: ``a1zero``, ``swapped``,
``prerot``, ``exact``; :func:`pair_measure_path`). Neither drops any
weight: the gadgets are exact where the split-op path truncates.

Every function takes chain tensors with a leading trajectory axis,
``(B, l, d, r)``; an unbatched call is ``B = 1``. Angles may be one per
trajectory where the JAX package allows a traced angle.

Sampling: the first and second outcomes are drawn per trajectory by
inverse CDF of the device distribution at host uniforms from one
``torch.Generator`` (:func:`_uniforms`), copied to the device without a
sync; ``force`` gives (mode-1 index, mode-2 index) instead, each an int or
one per trajectory. In the swapped path mode 2 is drawn first.

Differences from the JAX package, all deliberate: the precision knobs
``QCT_FUSED_P1_PREC`` and ``QCT_FUSED_TAB_PREC`` (TPU matmul passes) are
not carried, every product runs in full FP32 on the card (no TF32) and in
complex128 on the CPU; ``QCT_FUSED_PAIR_GRAM`` and
``QCT_FUSED_EXACT_PREROT`` are the ``gram=`` and ``prerot=`` defaults
(on), with no environment variable; the ``fori_loop`` row scans are
chunked, vectorised passes; grid tables (sinc sampling matrices, Fourier
phases, rotation kernels) are formed in float64 on the device and cast
last; the chain environments and their Newton-Schulz square roots are
formed in complex128 on every device (in complex64 the square root of a
nearly singular 2 x 2 environment diverged and turned a trajectory's
first distribution into NaN on an H100).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import full_fp32_matmul, to_device
from ..utils.profiling import span
from ..utils.rng import draw_batch
from .interp import rotation
from .linalg import _ns_inv_sqrt

__all__ = ["fused_single_gadget", "fused_pair_measure2", "pair_measure_path"]

# gram= and prerot= defaults of fused_pair_measure2 (the JAX package's
# QCT_FUSED_PAIR_GRAM and QCT_FUSED_EXACT_PREROT defaults).
_PAIR_GRAM_DEFAULT = True
_PAIR_PREROT_DEFAULT = True

# A prerot residual a2 - a1 with 1e-12 <= |a2 - a1| and |sin(a2 - a1)|
# below this falls back to the exact-kernel path (the residual rotation is
# singular where sin = 0).
_PREROT_SIN_MIN = 1e-6

# Complex elements of one chunk of a vectorised row scan.
_CHUNK_ELEMENTS = 1 << 24


def _per_trajectory(angle) -> bool:
    """True for one angle per trajectory (the JAX package's traced angle)."""
    return isinstance(angle, torch.Tensor) or np.ndim(angle) > 0


def _angles(angles):
    """One angle per trajectory, float64: a tensor stays where it is, an
    array stays on the host (``interp.rotation`` copies it without a sync)."""
    if isinstance(angles, torch.Tensor):
        return angles.to(torch.float64)
    return np.asarray(angles, np.float64)


def _prerot_applies(a1: float, a2) -> bool:
    """True when fused_pair_measure2 reroutes (a1, a2) through the prerot
    commute identity (given prerot enabled). a2 may be per trajectory."""
    if float(a1) == 0.0:
        return False
    if _per_trajectory(a2):
        return True  # the residual is not one angle; prerot applies
    a2 = float(a2)
    if abs(a2) < 1e-12:
        return False  # order-swapped fast path
    resid = a2 - float(a1)
    return abs(resid) < 1e-12 or abs(math.sin(resid)) >= _PREROT_SIN_MIN


def pair_measure_path(a1: float, a2, prerot: bool | None = None) -> str:
    """The path fused_pair_measure2 takes for (a1, a2): 'swapped',
    'a1zero', 'prerot' or 'exact' (the profiling span's label)."""
    if prerot is None:
        prerot = _PAIR_PREROT_DEFAULT
    if float(a1) == 0.0:
        return "a1zero"
    if not _per_trajectory(a2) and abs(float(a2)) < 1e-12:
        return "swapped"
    if prerot and _prerot_applies(a1, a2):
        return "prerot"
    return "exact"


def _grid(qs, device) -> torch.Tensor:
    """The numpy grid as float64 on ``device`` (no sync)."""
    return to_device(np.asarray(qs, np.float64), device)


def _uniforms(n: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """``n`` float64 uniforms in [0, 1) from ``generator``, on ``device``
    (one per trajectory: :func:`..utils.rng.draw_batch`)."""
    if generator is None:
        raise ValueError("an unforced homodyne requires a torch.Generator")
    u = draw_batch(generator, n, lambda m: torch.rand(
        m, generator=generator, dtype=torch.float64, device=generator.device))
    return to_device(u, device)


def _draw(dist: torch.Tensor, forced, generator) -> torch.Tensor:
    """One grid index per trajectory of ``dist`` (B, d): ``forced`` (an int
    or one per trajectory), else the inverse CDF of ``dist`` at a uniform
    (bins of zero weight are never drawn). Stays on the device."""
    B, d = dist.shape
    if forced is not None:
        if isinstance(forced, torch.Tensor):
            idx = forced.to(dist.device, torch.int64)
        else:
            idx = to_device(np.asarray(forced, np.int64), dist.device)
        return idx.reshape(-1).expand(B).contiguous()
    cdf = torch.cumsum(dist.to(torch.float64), -1)
    target = _uniforms(B, generator, dist.device) * cdf[:, -1]
    idx = torch.searchsorted(cdf, target[:, None], right=True)[:, 0]
    return idx.clamp_(max=d - 1)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] of a (B, d) tensor."""
    return torch.take_along_dim(x, idx[:, None], 1)[:, 0]


@full_fp32_matmul()
def _psd_sqrt(G: torch.Tensor) -> torch.Tensor:
    """Hermitian PSD square root of each (n, n) matrix of a batch by the
    matmul-only Newton-Schulz inverse square root; n = 1 directly."""
    if G.shape[-1] == 1:
        return torch.sqrt(torch.clamp(G.real, min=0.0)).to(G.dtype)
    return G @ _ns_inv_sqrt(G)


def _left_env(tensors, like: torch.Tensor) -> torch.Tensor:
    """Transfer-matrix left environment (B, r, r) of a batched chain, in
    complex128 (``like`` gives B and the device of an empty one)."""
    res = like.new_ones((like.shape[0], 1, 1), dtype=torch.complex128)
    for t in tensors:
        t = t.to(torch.complex128)
        res = torch.einsum("zab,zaci,zbcj->zij", res, t, t.conj())
    return res


def _right_env(tensors, like: torch.Tensor) -> torch.Tensor:
    res = like.new_ones((like.shape[0], 1, 1), dtype=torch.complex128)
    for t in reversed(tensors):
        t = t.to(torch.complex128)
        res = torch.einsum("zica,zjcb,zab->zij", t, t.conj(), res)
    return res


def _stretch_sample_matrix(qs, stretch: float, refine: int, pad: int,
                           device="cpu"):
    """Sinc-sampling matrix onto a zero-padded stretched grid.

    Rows are the padded grid points ``xi_m = stretch*q0 + (m - refine*pad)*h``
    with ``h = stretch*dq/refine``; the core points ``xi = stretch*q_j`` sit at
    ``m = refine*(pad + j)``. Points outside the original domain are zeroed
    so Fourier shifts wrap only zeros and tails. ``M = refine*(d + 2 pad)``.
    Returns (S (M, d) float64 on ``device``, M, h).
    """
    qs = np.asarray(qs)
    d = int(qs.shape[0])
    dq = float((qs[-1] - qs[0]) / (d - 1))
    h = stretch * dq / refine
    M = refine * (d + 2 * pad)
    xi = stretch * float(qs[0]) + (
        torch.arange(M, dtype=torch.float64, device=device) - refine * pad) * h
    S = torch.sinc((xi[:, None] - _grid(qs, device)[None, :]) / dq)
    inside = (xi >= float(qs[0]) - 1e-9) & (xi <= float(qs[-1]) + 1e-9)
    return S * inside[:, None], M, h


def _core_slice(x: torch.Tensor, refine: int, pad: int, d: int) -> torch.Tensor:
    """Strided slice of the padded-grid axis (-1) back to the d core points."""
    start = refine * pad
    return x[..., start:start + refine * (d - 1) + 1:refine]


def _phase(freqs: torch.Tensor, deltas: torch.Tensor, dtype) -> torch.Tensor:
    """exp(2 pi i f delta), (..., M) for deltas (...,), formed in float64."""
    return torch.exp(2j * math.pi * freqs * deltas[..., None]).to(dtype)


def _shift_eval(lines_f: torch.Tensor, freqs: torch.Tensor,
                deltas: torch.Tensor) -> torch.Tensor:
    """Evaluate FFT'd padded lines shifted by ``deltas``: returns
    ``(..., n_delta, M)`` with entry ``line(x + delta)`` on the padded grid."""
    return torch.fft.ifft(lines_f[..., None, :] * _phase(freqs, deltas, lines_f.dtype),
                          dim=-1)


def _real_matmul(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """S (M, d), real, times each complex (d, n) matrix of x (..., d, n) as
    one real product."""
    n = x.shape[-1]
    xr = torch.view_as_real(x.resolve_conj().contiguous()).reshape(*x.shape[:-1], 2 * n)
    y = S.to(xr.dtype) @ xr
    return torch.view_as_complex(y.reshape(*y.shape[:-1], n, 2))


def _chunk_rows(n_rows: int, per_row: int) -> int:
    """Rows per chunk of a row scan whose rows hold ``per_row`` elements."""
    return max(1, min(n_rows, _CHUNK_ELEMENTS // max(1, per_row)))


@full_fp32_matmul()
def fused_single_gadget(tensors, idx: int, qs, bell, a1, a2,
                        generator: torch.Generator | None = None, *,
                        bs_angle: float = np.pi / 4, force=None,
                        line_chunk: int = 1024, diagnostics: bool = False):
    """Execute one single-mode MB gadget without any SVD.

    tensors: list of (B, l, d, r) chain tensors; ``tensors[idx]`` is the
    input mode. qs: the numpy grid. bell: (B, d, 2) or (d, 2) Bell column
    vectors (the second Bell tensor is their transpose). a1: the first
    homodyne angle (one number); a2: the second (a number, or one per
    trajectory). force: optional (i, j) grid indices. Returns
    ``(new_tensors, m1, m2[, diag])`` with ``new_tensors[idx]`` the
    teleported output, of the input mode's shape, and m1, m2 (B,) float64
    outcomes on the device.
    """
    t1 = tensors[idx]
    B, a, d, k = t1.shape
    L0 = len(tensors)
    qs_np = np.asarray(qs)
    dev = t1.device
    q = _grid(qs_np, dev)
    dq = float((qs_np[-1] - qs_np[0]) / (d - 1))
    cth, sth = float(np.cos(bs_angle)), float(np.sin(bs_angle))
    cdt = t1.dtype
    rdt = t1.real.dtype
    tiny = torch.finfo(rdt).tiny
    a1 = float(a1)
    bell = bell.to(dev, cdt).expand(B, d, 2)

    with span("fused:envs"):
        b1 = bell
        if a1 != 0.0:
            t1 = rotation(q, t1, -a1, axis=2)
            b1 = rotation(q, b1, -a1, axis=1)

        # Environments and their Hermitian PSD square roots (matmul-only), in
        # complex128.
        S_L = _psd_sqrt(_left_env(tensors[:idx], t1)).to(cdt)                # (B, a, a)
        S_E = _psd_sqrt(_right_env(tensors[idx + 1:], t1)).to(cdt)           # (B, k, k)
        b128 = bell.to(torch.complex128)
        S_G = _psd_sqrt(torch.einsum("zys,zyt->zst", b128, b128.conj())).to(cdt)  # (B, 2, 2)

    with span("fused:first"):
        # Dressed line families: G from the input factor, H from the Bell factor.
        t1e = torch.einsum("zpa,zaik,zkg->zipg", S_L.conj(), t1, S_E).reshape(B, d, a * k)
        b1d = b1 @ S_G                                             # (B, d, 2)

        # Padding absorbs the largest Fourier shift, so wraps touch only zeros.
        pad = int(np.ceil(max(cth / sth, sth / cth) * (d - 1) / 2)) + 1
        S2G, MG, hG = _stretch_sample_matrix(qs_np, sth, 2, pad, dev)
        S2H, MH, hH = _stretch_sample_matrix(qs_np, cth, 2, pad, dev)

        # G(x) = sum over dressed lines of |line(x)|^2 on the half-spacing grid
        # (|f|^2 has twice f's bandwidth).
        G = torch.zeros((B, MG), dtype=rdt, device=dev)
        for c0 in range(0, a * k, line_chunk):
            u = _real_matmul(S2G, t1e[:, :, c0:c0 + line_chunk])
            G += torch.sum(u.real ** 2 + u.imag ** 2, -1)
        uh = _real_matmul(S2H, b1d)
        H = torch.sum(uh.real ** 2 + uh.imag ** 2, -1)

        # p1(i) = dq^(L+1) sum_j G(c q_i + s q_j) H(-s q_i + c q_j): Fourier-shift
        # G by c q_i (and H by -s q_i) and read the strided core, rows in chunks.
        Gf = torch.fft.fft(G.to(cdt), dim=-1)
        Hf = torch.fft.fft(H.to(cdt), dim=-1)
        freqsG = torch.fft.fftfreq(MG, d=hG, dtype=torch.float64, device=dev)
        freqsH = torch.fft.fftfreq(MH, d=hH, dtype=torch.float64, device=dev)
        p1_raw = torch.empty((B, d), dtype=rdt, device=dev)
        ic = _chunk_rows(d, B * max(MG, MH))
        for r0 in range(0, d, ic):
            qi = q[r0:r0 + ic]
            Grow = _core_slice(_shift_eval(Gf, freqsG, cth * qi).real, 2, pad, d)
            Hrow = _core_slice(_shift_eval(Hf, freqsH, -sth * qi).real, 2, pad, d)
            p1_raw[:, r0:r0 + ic] = torch.sum(Grow * Hrow, -1)
        rho1 = torch.clamp(p1_raw, min=0.0) * dq ** (L0 + 1)
        with span("fused:draw"):
            i_star = _draw(rho1 * dq, None if force is None else force[0], generator)
        m1 = q[i_star]
        p1v = _at(rho1, i_star)

        # Collapse: raw (undressed) line evaluation at the sampled row.
        S1G, M1G, h1G = _stretch_sample_matrix(qs_np, sth, 1, pad, dev)
        S1H, M1H, h1H = _stretch_sample_matrix(qs_np, cth, 1, pad, dev)
        f1G = torch.fft.fftfreq(M1G, d=h1G, dtype=torch.float64, device=dev)
        f1H = torch.fft.fftfreq(M1H, d=h1H, dtype=torch.float64, device=dev)
        t1_lines = t1.permute(0, 2, 1, 3).reshape(B, d, a * k)
        u_f = torch.fft.fft(_real_matmul(S1G, t1_lines), dim=1)   # (B, M1G, a k)
        shifted = torch.fft.ifft(u_f * _phase(f1G, cth * m1, cdt)[:, :, None], dim=1)
        B1 = shifted[:, pad:pad + d].reshape(B, d, a, k).permute(0, 2, 1, 3)
        ub_f = torch.fft.fft(_real_matmul(S1H, b1), dim=1)        # (B, M1H, 2)
        ub_s = torch.fft.ifft(ub_f * _phase(f1H, -sth * m1, cdt)[:, :, None], dim=1)
        brow = ub_s[:, pad:pad + d]                                # (B, d, 2)

        scale = torch.rsqrt(torch.clamp(p1v, min=tiny)).to(cdt)[:, None, None, None, None]
        Bt = (B1[..., None] * brow[:, None, :, None, :] * scale).reshape(B, a, d, 2 * k)

    with span("fused:second"):
        # Second homodyne: the commuted trailing R2(+a1) and the measurement
        # pre-rotation R2(-a2) compose to one rotation by (a1 - a2). One angle
        # per trajectory is always applied, as the JAX package applies a traced
        # angle.
        if _per_trajectory(a2):
            Bt = rotation(q, Bt, a1 - _angles(a2), axis=2)
        elif abs(a1 - float(a2)) >= 1e-12:
            Bt = rotation(q, Bt, a1 - float(a2), axis=2)

        Bd = torch.einsum("zpa,zajc->zpjc", S_L.conj(), Bt)
        Bd = torch.einsum("zpjks,zkg,zst->zpjgt", Bd.reshape(B, -1, d, k, 2), S_E, S_G)
        rho2 = torch.clamp(torch.sum(Bd.real ** 2 + Bd.imag ** 2, (1, 3, 4)), min=0.0) * dq ** L0
        with span("fused:draw"):
            j_star = _draw(rho2 * dq, None if force is None else force[1], generator)
        m2 = q[j_star]
        p2v = _at(rho2, j_star)

        Mj = torch.take_along_dim(Bt, j_star[:, None, None, None], 2)[:, :, 0]  # (B, a, 2k)
        Mj = Mj * torch.rsqrt(torch.clamp(p2v, min=tiny)).to(cdt)[:, None, None]
        # Exact contraction with the second Bell tensor:
        # out[a, x, k] = sum_s M[a, (k, s)] bell[x, s].
        out = torch.einsum("zaks,zxs->zaxk", Mj.reshape(B, a, k, 2), bell)

    new_tensors = list(tensors)
    new_tensors[idx] = out
    if diagnostics:
        return new_tensors, m1, m2, {"rho1": rho1, "rho2": rho2, "p1": p1v,
                                     "p2": p2v, "i": i_star, "j": j_star}
    return new_tensors, m1, m2


def _gram_corr_p1(lines1e, lines2e, qs_np, pad: int, a: int, k: int, c: int,
                  *, swapped: bool) -> torch.Tensor:
    """First-homodyne distribution of the fused pair-measure as a lattice
    correlation of two Gram tabulations (bs_angle = pi/4, symmetric grid).

    At 45 degrees the post-BS pair amplitude on row ``i`` is
    ``C_ij[a,c] = sum_k f1e[ak](s(q_i+q_j)) f2e[kc](s(q_j-q_i))`` (swapped:
    ``s(q_i-q_j)``), so ``sum_ac |C_ij|^2 = sum_kk' G1[kk'](u_ij) G2[kk'](v_ij)``
    with per-point k x k Grams of the two factors. Both arguments live on
    one parity class of the half-spacing s-stretched lattice, where the
    j-sum is a cross-correlation (swapped: a convolution): two tabulation
    matmuls, the Grams and one zero-padded FFT correlation, O(d^2 chi^2)
    instead of the row scan's O(d^2 chi^3). The k' axis runs in chunks.
    """
    B = lines1e.shape[0]
    dev = lines1e.device
    rdt = lines1e.real.dtype
    d = int(qs_np.shape[0])
    sth = float(np.cos(np.pi / 4))
    rho = (d - 1) % 2
    S2, _, _ = _stretch_sample_matrix(qs_np, sth, 2, pad, dev)
    Sf = S2[rho::2]                                   # (m_eff, d) parity rows
    m_eff = Sf.shape[0]
    n_fft = 1 << int(2 * m_eff - 1).bit_length()

    U1 = _real_matmul(Sf, lines1e).reshape(B, m_eff, a, k)
    U2 = _real_matmul(Sf, lines2e).reshape(B, m_eff, k, c)

    lc = k if k <= 16 else 8
    spec = torch.zeros((B, n_fft), dtype=U1.dtype, device=dev)
    for l0 in range(0, k, lc):
        G1c = torch.einsum("zmak,zmal->zmkl", U1, U1[..., l0:l0 + lc].conj())
        G2c = torch.einsum("zmkc,zmlc->zmkl", U2, U2[:, :, l0:l0 + lc].conj())
        F1c = torch.fft.fft(G1c, n=n_fft, dim=1)
        F2c = torch.fft.fft(G2c, n=n_fft, dim=1)
        if not swapped:
            # correlation C[tau] = sum_m g[m+tau] h[m]: spectrum g(w) h(-w)
            F2c = torch.roll(torch.flip(F2c, (1,)), 1, 1)
        spec += torch.einsum("zwkl,zwkl->zw", F1c, F2c)
    if swapped:
        # indices moving oppositely: a convolution, read at 2(pad+i) - rho
        idx = (2 * (pad + np.arange(d)) - rho) % n_fft
    else:
        idx = (2 * np.arange(d) - (d - 1)) % n_fft
    C = torch.fft.ifft(spec, dim=-1).real
    return C[:, to_device(idx, dev)].to(rdt)


def _rotation_kernel_row(q: torch.Tensor, theta: float, q_m: torch.Tensor) -> torch.Tensor:
    """Rows of the ops/interp.rotation kernel at output coordinates ``q_m``
    (one per trajectory), with the dq measure: (B, d) complex128. Applying a
    row along an axis equals reading ``rotation(qs, ., theta, axis)`` at the
    grid point q_m."""
    d = q.shape[0]
    dq = (q[-1] - q[0]) / (d - 1)
    cos, sin = math.cos(theta), math.sin(theta)
    exponent = cos * (q[None, :] ** 2 + q_m[:, None] ** 2) / 2.0 - q_m[:, None] * q[None, :]
    row = (2 * math.pi * abs(sin)) ** -0.5 * torch.exp(exponent / (1j * sin))
    return row * dq


@full_fp32_matmul()
def fused_pair_measure2(tensors, m: int, qs, a1, a2,
                        generator: torch.Generator | None = None, *,
                        bs_angle: float = np.pi / 4, force=None,
                        gram: bool | None = None, prerot: bool | None = None,
                        diagnostics: bool = False):
    """BS(m, m+1) followed by homodynes on BOTH pair modes, SVD-free.

    The companion of :func:`fused_single_gadget` for the macronode's third
    and fourth beamsplitters, whose operands are generic factors sharing a
    bond k (B, a, d, k) x (B, k, d, c). The first distribution is a scan of
    the virtual post-BS pair's lines (Fourier shift + core slice of padded
    stretched tabulations), or with ``gram`` its Gram-factorised
    correlation (:func:`_gram_corr_p1`); the collapse conditions on the
    drawn row and the second homodyne acts on the materialised (a, d, c)
    conditional tensor. Paths by the angles: ``a1 == 0`` scans the measured
    mode's rows; ``a1 != 0, a2 == 0`` measures the unrotated second mode
    first (``swapped``); both nonzero either commute the first rotation
    through the BS onto both factors (``prerot``, the default) or apply the
    true fractional-Fourier kernel along the virtual lines (``exact``).
    The final (a, c) matrix is absorbed into a neighbour by the ``Mq``
    smaller-intermediate rule. Returns ``(new_tensors, m1, m2[, diag])``
    with the pair removed.
    """
    t1, t2 = tensors[m], tensors[m + 1]
    B, a, d, k = t1.shape
    c = t2.shape[-1]
    L0 = len(tensors)
    qs_np = np.asarray(qs)
    dev = t1.device
    q = _grid(qs_np, dev)
    dq = float((qs_np[-1] - qs_np[0]) / (d - 1))
    cth, sth = float(np.cos(bs_angle)), float(np.sin(bs_angle))
    cdt = t1.dtype
    rdt = t1.real.dtype
    tiny = torch.finfo(rdt).tiny
    a1 = float(a1)
    batched2 = _per_trajectory(a2)
    a2 = _angles(a2) if batched2 else float(a2)
    if prerot is None:
        prerot = _PAIR_PREROT_DEFAULT
    symmetric = np.allclose(qs_np + qs_np[::-1], 0.0, atol=1e-9)
    if (prerot and a1 != 0.0 and (batched2 or abs(a2) >= 1e-12)
            and _prerot_applies(a1, a2)):
        # Both angles nonzero: commute the first homodyne's rotation
        # through the BS onto both factors; the measure then runs on the
        # a1 == 0 path.
        if not symmetric:
            raise ValueError("fused pair measure with a1 != 0 needs a symmetric grid")
        t1 = rotation(q, t1, -a1, axis=2)
        t2 = rotation(q, t2, -a1, axis=2)
        a2 = a2 - a1
        a1 = 0.0

    S_L = _psd_sqrt(_left_env(tensors[:m], t1)).to(cdt)       # (B, a, a)
    S_R = _psd_sqrt(_right_env(tensors[m + 2:], t1)).to(cdt)  # (B, c, c)
    t1e = torch.einsum("zpa,zaik->zpik", S_L.conj(), t1)
    t2e = torch.einsum("zkic,zcg->zkig", t2, S_R)

    pad = int(np.ceil(max(cth / sth, sth / cth) * (d - 1) / 2)) + 1

    def make_tab(stretch):
        S, M, h = _stretch_sample_matrix(qs_np, stretch, 1, pad, dev)
        return S, torch.fft.fftfreq(M, d=h, dtype=torch.float64, device=dev)

    def tab(lines, S):
        """(B, d, n) lines -> FFT'd padded stretched tabulation (B, M, n)."""
        return torch.fft.fft(_real_matmul(S, lines), dim=1)

    def rows(f_tab, freqs, deltas, shape, flip=False):
        """Lines of f_tab shifted by each delta, (B, Y, d, *shape), for
        deltas (Y,) shared by the batch or (B, Y)."""
        w = torch.fft.ifft(f_tab[:, None] * _phase(freqs, deltas, cdt)[..., None], dim=2)
        w = w[:, :, pad:pad + d]
        if flip:
            # f(-|s| q_x + delta) on a symmetric grid is the reversed core
            w = torch.flip(w, (2,))
        return w.reshape(*w.shape[:3], *shape)

    def lines(t):
        return t.permute(0, 2, 1, 3).reshape(B, d, -1)

    lines1, lines2, lines1e, lines2e = lines(t1), lines(t2), lines(t1e), lines(t2e)
    swapped = a1 != 0.0 and not batched2 and abs(a2) < 1e-12
    if (swapped or a1 != 0.0) and not symmetric:
        raise ValueError("fused pair measure with a1 != 0 needs a symmetric grid")
    if gram is None:
        gram = _PAIR_GRAM_DEFAULT
    use_gram = gram and abs(cth - sth) < 1e-12 and symmetric
    M_tab = d + 2 * pad
    ic = _chunk_rows(d, B * M_tab * max(a * k, k * c, a * c))

    if swapped or a1 != 0.0:
        SC, freqsC = make_tab(cth)   # t1 lines as functions of x (stretch c)
        SS, freqsS = make_tab(sth)   # t2 lines as functions of x (stretch -s, by flip)
    else:
        SG, freqsG = make_tab(sth)   # t1 lines as functions of j (stretch s)
        SH, freqsH = make_tab(cth)   # t2 lines as functions of j (stretch c)

    if use_gram and (swapped or a1 == 0.0):
        p1_raw = _gram_corr_p1(lines1e, lines2e, qs_np, pad, a, k, c, swapped=swapped)
    elif swapped or a1 == 0.0:
        # scan rows y of the first-measured mode (swapped: the unrotated
        # second mode)
        if swapped:
            f1, f2 = tab(lines1e, SC), tab(lines2e, SS)
        else:
            f1, f2 = tab(lines1e, SG), tab(lines2e, SH)
        p1_raw = torch.empty((B, d), dtype=rdt, device=dev)
        for y0 in range(0, d, ic):
            qy = q[y0:y0 + ic]
            if swapped:
                W1 = rows(f1, freqsC, sth * qy, (a, k))             # t1e(c q_x + s q_y)
                W2 = rows(f2, freqsS, cth * qy, (k, c), flip=True)  # t2e(-s q_x + c q_y)
            else:
                W1 = rows(f1, freqsG, cth * qy, (a, k))
                W2 = rows(f2, freqsH, -sth * qy, (k, c))
            A = torch.einsum("zyxak,zyxkc->zyxac", W1, W2)
            p1_raw[:, y0:y0 + ic] = torch.sum(A.real ** 2 + A.imag ** 2, (2, 3, 4))
    else:
        # exact kernel: the frFT kernel along the virtual x-lines per column y
        f1, f2 = tab(lines1e, SC), tab(lines2e, SS)
        p1_raw = torch.zeros((B, d), dtype=rdt, device=dev)
        for y0 in range(0, d, ic):
            qy = q[y0:y0 + ic]
            W1 = rows(f1, freqsC, sth * qy, (a, k))
            W2 = rows(f2, freqsS, cth * qy, (k, c), flip=True)
            A = torch.einsum("zyxak,zyxkc->zyxac", W1, W2)
            phi = rotation(q, A, -a1, axis=2)                      # (B, Y, d_m, a, c)
            p1_raw += torch.sum(phi.real ** 2 + phi.imag ** 2, (1, 3, 4))

    # force is (mode-1 index, mode-2 index); swapped measures mode 2 first.
    rho1 = torch.clamp(p1_raw, min=0.0) * dq ** (L0 - 1)
    first = None if force is None else force[1] if swapped else force[0]
    s1_idx = _draw(rho1 * dq, first, generator)
    v1 = q[s1_idx]
    p1v = _at(rho1, s1_idx)

    # Collapse from the RAW (undressed) factors at the drawn outcome.
    if swapped:
        W1r = rows(tab(lines1, SC), freqsC, (sth * v1)[:, None], (a, k))[:, 0]
        W2r = rows(tab(lines2, SS), freqsS, (cth * v1)[:, None], (k, c), flip=True)[:, 0]
        Bt = torch.einsum("zxak,zxkc->zaxc", W1r, W2r)
    elif a1 == 0.0:
        W1r = rows(tab(lines1, SG), freqsG, (cth * v1)[:, None], (a, k))[:, 0]
        W2r = rows(tab(lines2, SH), freqsH, (-sth * v1)[:, None], (k, c))[:, 0]
        Bt = torch.einsum("zjak,zjkc->zajc", W1r, W2r)
    else:
        f1r, f2r = tab(lines1, SC), tab(lines2, SS)
        krow = _rotation_kernel_row(q, -a1, v1).to(cdt)           # (B, d_x)
        Bt = torch.empty((B, a, d, c), dtype=cdt, device=dev)
        for y0 in range(0, d, ic):
            qy = q[y0:y0 + ic]
            W1 = rows(f1r, freqsC, sth * qy, (a, k))
            W2 = rows(f2r, freqsS, cth * qy, (k, c), flip=True)
            A = torch.einsum("zyxak,zyxkc->zyxac", W1, W2)
            Bt[:, :, y0:y0 + ic] = torch.einsum("zx,zyxac->zayc", krow, A)

    Bt = Bt * torch.rsqrt(torch.clamp(p1v, min=tiny)).to(cdt)[:, None, None, None]

    # Second measurement: mode 1 (angle a1) in swapped order, else mode 2
    # (angle a2, possibly one per trajectory).
    if swapped:
        Bt = rotation(q, Bt, -a1, axis=2)
    elif batched2:
        Bt = rotation(q, Bt, -a2, axis=2)
    elif abs(a2) >= 1e-12:
        Bt = rotation(q, Bt, -a2, axis=2)

    Bd = torch.einsum("zpa,zajc,zcg->zpjg", S_L.conj(), Bt, S_R)
    rho2 = torch.clamp(torch.sum(Bd.real ** 2 + Bd.imag ** 2, (1, 3)), min=0.0) * dq ** (L0 - 2)
    second = None if force is None else force[0] if swapped else force[1]
    s2_idx = _draw(rho2 * dq, second, generator)
    v2 = q[s2_idx]
    p2v = _at(rho2, s2_idx)

    Mj = torch.take_along_dim(Bt, s2_idx[:, None, None, None], 2)[:, :, 0]  # (B, a, c)
    Mj = Mj * torch.rsqrt(torch.clamp(p2v, min=tiny)).to(cdt)[:, None, None]
    m1, m2 = (v2, v1) if swapped else (v1, v2)

    # Absorb into a neighbour (the Mq smaller-intermediate rule).
    new_tensors = list(tensors)
    del new_tensors[m:m + 2]
    has_left, has_right = m > 0, m + 2 < L0
    if not (has_left or has_right):
        raise ValueError("fused_pair_measure2 cannot remove the whole chain")
    if has_left and (a >= c or not has_right):
        new_tensors[m - 1] = torch.einsum("zlxa,zac->zlxc", tensors[m - 1], Mj)
    else:
        new_tensors[m] = torch.einsum("zac,zcxr->zaxr", Mj, tensors[m + 2])
    if diagnostics:
        return new_tensors, m1, m2, {"rho1": rho1, "rho2": rho2, "p1": p1v,
                                     "p2": p2v, "swapped": swapped,
                                     "i": s1_idx, "j": s2_idx}
    return new_tensors, m1, m2
