"""Gadget building blocks of the batched GKP engine (counterpart of the
helpers of ``quantum_computations_tpu/gkp/compiled.py``).

The JAX package writes these on one MPS and vmaps them over trajectories;
here they act on a batched chain, a list of (B, l, d, r) tensors, one
trajectory per row of the leading axis. Bell insertion is the exact,
SVD-free splice; a beamsplitter contracts, rotates and splits every
trajectory at one common cap with its truncated directions zero-masked
(streamed above ``cv.gates._STREAM_THRESHOLD``); a homodyne draws one
outcome per trajectory without a sync. Syndromes are host numpy.
``CompiledGKP``, the whole-circuit program, is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SVDOptions, full_fp32_matmul, to_device
from ..cv import gates as cvg
from ..cv.states import State as CVState
from ..ops import interp
from ..ops.fused_gadget import _at, _draw, _grid, _left_env, _right_env
from ..ops.linalg import tensor_svd
from ..ops.streamed import effective_power_iters, streamed_pair_svd_batched
from .bell import splice_product_segment
from .gates import MB2Type

SQPI = np.sqrt(np.pi)
ARCTAN2 = float(np.arctan(2))


def gkp_basis(q: torch.Tensor, epsilon: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The grid-normalised GKP |0> and |1> on the float64 grid ``q``,
    complex128 on its device."""
    return (CVState.GKP_ZERO.eval(q, epsilon, dtype=torch.complex128),
            CVState.GKP_ONE.eval(q, epsilon, dtype=torch.complex128))


def bell_vectors(basis, coeff1, dtype) -> torch.Tensor:
    """(B, d, 2) Bell column vectors 2^(-1/4) (|0>, c1 |1>) for one second
    logical coefficient c1 per trajectory (host complex array), in
    ``dtype``."""
    zero, one = basis
    c1 = to_device(np.asarray(coeff1, np.complex128), one.device)
    bell = torch.stack([zero.expand(c1.shape[0], -1), c1[:, None] * one], -1)
    return (2 ** (-1 / 4) * bell).to(dtype)


def _insert_bell(tensors, idx: int, bell: torch.Tensor):
    """Insert a Bell pair (B, d, 2) at ``idx`` of a batched chain: at an
    end as two new tensors, inside as the exact product-segment splice."""
    b_left = bell[:, None]                       # (B, 1, d, 2)
    b_right = b_left.permute(0, 3, 2, 1)         # (B, 2, d, 1)
    if idx == 0:
        return [b_left, b_right] + list(tensors)
    if idx == len(tensors):
        return list(tensors) + [b_left, b_right]
    b1_t, b2_t = splice_product_segment(tensors[idx - 1], bell, b_right[..., 0])
    return list(tensors[:idx]) + [b1_t, b2_t] + list(tensors[idx:])


@full_fp32_matmul()
def _bs_split(tensors, i: int, j: int, opts: SVDOptions, generator, qs):
    """BS(i, j) on neighbouring modes of a batched chain: contract, rotate
    (three FFT shears), and split every trajectory at one cap with its
    truncated directions zero-masked: materialised (cap min(bucket(mbd),
    mbd)), or streamed above the threshold (cap min(mbd, a d, d b)).
    Returns (tensors, ranks): ranks a host int array (B,) of a streamed
    split, else None (the kept ranks stay on the device, in the mask)."""
    li, ri = (i, j) if i < j else (j, i)
    t1, t2 = tensors[li], tensors[ri]
    _, a, d, _ = t1.shape
    b = t2.shape[-1]
    angle = float(np.pi / 4) * (-1) ** (i > j)
    q = _grid(qs, t1.device)
    out = list(tensors)
    if cvg._use_streamed(a, d, b, opts):
        cap = min(opts.max_bond_dim, a * d, d * b)
        q_iters = effective_power_iters(7 if cap + 10 < 0.1 * min(a * d, d * b) else 4)
        out[li], out[ri], ranks = streamed_pair_svd_batched(
            t1, t2, q, ("rot", angle), max_bond_dim=opts.max_bond_dim,
            abs_err=opts.abs_err, rel_err=opts.rel_err, generator=generator,
            power_iters=q_iters)
        return out, ranks
    # trajectories per pass: a pass holds at most the threshold's elements
    # of the contracted pair (the JAX package's vmapped split holds them all)
    per = max(1, cvg._STREAM_THRESHOLD // (a * d * d * b))
    parts = []
    for z0 in range(0, t1.shape[0], per):
        res = torch.einsum("zaik,zkjb->zaijb", t1[z0:z0 + per], t2[z0:z0 + per])
        res = interp.affine_warp(q, res, ("rot", angle), axis_x=2, axis_y=3)
        parts.append(tensor_svd(
            res, (0, 1), (2, 3), max_bond_dim=opts.max_bond_dim,
            abs_err=opts.abs_err, rel_err=opts.rel_err, generator=generator,
            svd_method=opts.svd_method, batch_dims=1)[:2])
        del res
    out[li], out[ri] = (torch.cat(f) if len(f) > 1 else f[0] for f in zip(*parts))
    return out, None


@full_fp32_matmul()
def _homodyne(tensors, idx: int, angle, generator, qs, *, static_zero: bool = False):
    """Homodyne of mode ``idx`` of a batched chain at ``angle`` (a number,
    or one per trajectory). Returns (tensors, outcomes (B,) float64 on the
    device). The outcome is drawn per trajectory from the grid-sampled
    position distribution (``cv.gates.Mq``'s measure); the collapsed
    mode's (l, r) matrix is absorbed into the neighbour that keeps the
    smaller intermediate, unless the chain has one mode."""
    tensors = list(tensors)
    q = _grid(qs, tensors[idx].device)
    if not static_zero:
        angle = angle if np.ndim(angle) == 0 else np.asarray(angle, np.float64)
        tensors[idx] = interp.rotation(q, tensors[idx], -angle, axis=2)
    t = tensors[idx]
    dq = float((qs[-1] - qs[0]) / (len(qs) - 1))
    left = _left_env(tensors[:idx], t).to(t.dtype)
    right = _right_env(tensors[idx + 1:], t).to(t.dtype)
    rho = torch.einsum("zab,zaic,zbie,zce->zi", left, t, t.conj(), right).real
    distribution = torch.clamp(rho * dq ** (len(tensors) - 1), min=0.0) * dq
    s_index = _draw(distribution, None, generator)
    s = q[s_index]
    if len(tensors) == 1:
        return tensors, s
    p = _at(distribution, s_index) / dq
    mode = torch.take_along_dim(t, s_index[:, None, None, None], 2)[:, :, 0]
    mode = mode * torch.rsqrt(torch.clamp(p, min=torch.finfo(p.dtype).tiny)).to(t.dtype)[:, None, None]
    l, r = mode.shape[1:]
    if l >= r and idx != 0:
        tensors[idx - 1] = torch.einsum("zlxa,zar->zlxr", tensors[idx - 1], mode)
    else:
        tensors[idx + 1] = torch.einsum("zla,zaxr->zlxr", mode, tensors[idx + 1])
    del tensors[idx]
    return tensors, s


def _syndrome_from(ta, tb, ma, mb) -> np.ndarray:
    """Byproduct syndrome bits (x, z), (..., 2) int32, of host outcomes
    ma, mb at syndrome angles ta, tb (float64 numpy)."""
    ta, tb, ma, mb = (np.asarray(x, np.float64) for x in (ta, tb, ma, mb))
    mu = 1j * (ma * np.exp(1j * tb) + mb * np.exp(1j * ta)) / np.sin(ta - tb)
    vec = np.stack([mu.real, mu.imag], axis=-1) * 2**0.5
    return np.round(vec / SQPI).astype(np.int32) % 2


def _two_mode_syndromes(mb2type: MB2Type, ms) -> np.ndarray:
    """(B, 2, 2) syndromes of a macronode gadget from host outcomes
    ms = (m_a, m_b, m_c, m_d)."""
    ta, tc, tb, td = mb2type.angles()
    ma, mb, mc, md = (np.asarray(x, np.float64) for x in ms)
    mu_ab = 1j * (ma * np.exp(1j * tb) + mb * np.exp(1j * ta)) / np.sin(ta - tb)
    mu_cd = 1j * (mc * np.exp(1j * td) + md * np.exp(1j * tc)) / np.sin(tc - td)
    out = []
    for mu in (mu_cd + mu_ab, mu_cd - mu_ab):
        vec = np.stack([mu.real, mu.imag], axis=-1)
        out.append(np.round(vec / SQPI).astype(np.int32) % 2)
    return np.stack(out, axis=1)


def _single_gadget(tensors, idx: int, meas_angles, syn_angles, bell: torch.Tensor,
                   opts: SVDOptions, generator, qs, *, a1_zero: bool = True):
    """Walshe single-mode gadget on a batched chain: Bell insertion, BS
    split, two homodynes. ``meas_angles`` are the measured angles (each a
    number or one per trajectory), ``syn_angles`` those of the syndrome
    formula (they differ for a Pauli-frame-flipped T). Returns (tensors,
    (B, 2) host syndromes)."""
    tensors = _insert_bell(tensors, idx + 1, bell)
    tensors, _ = _bs_split(tensors, idx, idx + 1, opts, generator, qs)
    tensors, m_a = _homodyne(tensors, idx, meas_angles[0], generator, qs,
                             static_zero=a1_zero)
    tensors, m_b = _homodyne(tensors, idx, meas_angles[1], generator, qs)
    ms = torch.stack([m_a, m_b], -1).cpu().numpy()
    return tensors, _syndrome_from(syn_angles[0], syn_angles[1], ms[:, 0], ms[:, 1])


def _two_mode_gadget(tensors, idx: int, mb2type: MB2Type, bell: torch.Tensor,
                     opts: SVDOptions, generator, qs):
    """Macronode two-mode gadget (static angles) on a batched chain: two
    Bell insertions (``bell``, coefficient 1), four BS splits, four
    homodynes. Returns (tensors, (B, 2, 2) host syndromes)."""
    ta, tc, tb, td = mb2type.angles()
    tensors = _insert_bell(tensors, idx, bell)
    tensors = _insert_bell(tensors, idx + 4, bell)
    tensors, _ = _bs_split(tensors, idx + 2, idx + 1, opts, generator, qs)
    tensors, _ = _bs_split(tensors, idx + 3, idx + 4, opts, generator, qs)
    tensors, _ = _bs_split(tensors, idx + 2, idx + 3, opts, generator, qs)
    tensors, m_a = _homodyne(tensors, idx + 2, ta, generator, qs, static_zero=(ta == 0.0))
    tensors, m_c = _homodyne(tensors, idx + 2, tc, generator, qs, static_zero=(tc == 0.0))
    tensors, _ = _bs_split(tensors, idx + 1, idx + 2, opts, generator, qs)
    tensors, m_b = _homodyne(tensors, idx + 1, tb, generator, qs, static_zero=(tb == 0.0))
    tensors, m_d = _homodyne(tensors, idx + 1, td, generator, qs, static_zero=(td == 0.0))
    ms = torch.stack([m_a, m_b, m_c, m_d]).cpu().numpy()
    return tensors, _two_mode_syndromes(mb2type, ms)


def logical_coeffs(dv_states) -> np.ndarray:
    """(N, 2, 2) real init-coefficient array from DV State enums."""
    from ..dv.states import State as DVState

    mapping = {
        DVState.ZERO: (1, 0), DVState.ONE: (0, 1),
        DVState.PLUS: (2**-0.5, 2**-0.5), DVState.MINUS: (2**-0.5, -(2**-0.5)),
        DVState.T: (2**-0.5, 2**-0.5 * np.exp(1j * np.pi / 4)),
        DVState.TDG: (2**-0.5, 2**-0.5 * np.exp(-1j * np.pi / 4)),
        DVState.H: (np.cos(np.pi / 8), np.sin(np.pi / 8)),
    }
    out = np.zeros((len(dv_states), 2, 2), dtype=np.float32)
    for i, s in enumerate(dv_states):
        a, b = mapping[s]
        out[i, 0] = (np.real(a), np.imag(a))
        out[i, 1] = (np.real(b), np.imag(b))
    return out
