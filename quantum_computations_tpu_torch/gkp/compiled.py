"""The whole-circuit GKP trajectory program and the gadget building blocks
of the batched engines (counterpart of
``quantum_computations_tpu/gkp/compiled.py``).

The JAX package writes the gadgets on one MPS and vmaps them over
trajectories; here they act on a batched chain, a list of (B, l, d, r)
tensors, one trajectory per row of the leading axis. Bell insertion is the
exact, SVD-free splice; a beamsplitter contracts, rotates and splits every
trajectory at one common cap with its truncated directions zero-masked
(streamed above ``cv.gates._STREAM_THRESHOLD``); a homodyne draws one
outcome per trajectory without a sync. The gadgets decode their syndromes
on the host (the path of :class:`.batched.BatchedGKP`) or, with
``host=False``, on the device.

:class:`CompiledGKP` is the counterpart of the JAX package's jitted and
vmapped program: one eager program over the leading trajectory axis in
which no host value steers the layer loop. Bonds stay at their static caps
(no trim, as under JAX's jit); the Pauli frame, the previous layer's
syndromes, the classically controlled P angle and the T gadget's frame
sign and Bell coefficient are device tensors; the readout returns the
syndrome-corrected, raw (not trace-normalised) logical density as real and
imaginary parts. The host waits only for the linear-algebra library:
cuSOLVER's ``eigh`` in the Gram SVD of a full materialised split whose
smaller side is above 128, and of a randomized split of fewer than
``ops.linalg.KERNEL_MIN_BATCH`` trajectories or with a bond cap under 23
(a larger batch's Grams, of side 33 to 128, go to the one-launch
``ops.herm_eigh_small`` kernel, which does not wait, and which marks a
matrix it did not converge on with NaN; a split above the stream
threshold would add the streamed path's host eigh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SVDOptions, complex_dtype, full_fp32_matmul, resolve_device, to_device
from ..cv import gates as cvg
from ..cv.states import State as CVState
from ..dv import gates as dv_gates
from ..dv.simulator import ClassicalControl
from ..ops import interp
from ..ops.fused_gadget import _at, _draw, _grid, _left_env, _right_env
from ..ops.linalg import fetch, tensor_svd
from ..ops.streamed import effective_power_iters, streamed_pair_svd_batched
from ..utils import as_generator
from ..utils.profiling import span
from .bell import splice_product_segment
from .gates import MB2Type
from .transpiler import MBGKPCircuit
from .utils import logical_density_batch

SQPI = np.sqrt(np.pi)
ARCTAN2 = float(np.arctan(2))


def gkp_basis(q: torch.Tensor, epsilon: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The grid-normalised GKP |0> and |1> on the float64 grid ``q``,
    complex128 on its device."""
    return (CVState.GKP_ZERO.eval(q, epsilon, dtype=torch.complex128),
            CVState.GKP_ONE.eval(q, epsilon, dtype=torch.complex128))


def bell_vectors(basis, coeff1, dtype) -> torch.Tensor:
    """(B, d, 2) Bell column vectors 2^(-1/4) (|0>, c1 |1>) for one second
    logical coefficient c1 per trajectory (a host complex array, or a
    device tensor), in ``dtype``."""
    zero, one = basis
    if isinstance(coeff1, torch.Tensor):
        c1 = coeff1.to(one.device, torch.complex128)
    else:
        c1 = to_device(np.asarray(coeff1, np.complex128), one.device)
    bell = torch.stack([zero.expand(c1.shape[0], -1), c1[:, None] * one], -1)
    return (2 ** (-1 / 4) * bell).to(dtype)


def product_tensors(basis, coeffs: np.ndarray, qs, batch: int, dtype) -> list[torch.Tensor]:
    """Batched GKP product state from (N, 2, 2) real logical coefficients:
    per mode a|0> + b|1>, grid-normalised, as (batch, 1, d, 1) tensors in
    ``dtype`` on the basis's device."""
    zero, one = basis
    c = np.asarray(coeffs, np.float64)
    dq = float(qs[1] - qs[0])
    tensors = []
    for i in range(c.shape[0]):
        psi = zero * complex(c[i, 0, 0], c[i, 0, 1]) + one * complex(c[i, 1, 0], c[i, 1, 1])
        psi = psi / torch.sqrt(torch.sum(psi.real ** 2 + psi.imag ** 2) * dq)
        tensors.append(psi.to(dtype).reshape(1, 1, -1, 1).repeat(batch, 1, 1, 1))
    return tensors


def corrected_density(tensors, frames: torch.Tensor, qs):
    """Syndrome-corrected logical density of a batch of chains: C rho C^H
    with C = kron_i X^x_i Z^z_i from the (B, N, 2) frames (a tensor on the
    chain's device). Returns (rho_re, rho_im), (B, 2^N, 2^N), not
    trace-normalised."""
    rho = logical_density_batch(tensors, qs)
    B, N = frames.shape[:2]
    eye = torch.eye(2, dtype=torch.float64, device=rho.device)
    X, Z = eye.flip(0), eye.clone()
    Z[1, 1] = -1.0
    corr = eye.new_ones((B, 1, 1))
    for i in range(N):
        m = torch.where(frames[:, i, 1, None, None] == 1, Z, eye)
        m = torch.where(frames[:, i, 0, None, None] == 1, X @ m, m)
        corr = torch.einsum("zab,zcd->zacbd", corr, m).reshape(
            B, corr.shape[1] * 2, corr.shape[2] * 2)
    corr = corr.to(rho.dtype)
    rho = corr @ rho @ corr.mH
    return rho.real, rho.imag


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
        with span("bs:contract"):
            res = torch.einsum("zaik,zkjb->zaijb", t1[z0:z0 + per], t2[z0:z0 + per])
        with span("bs:warp"):
            res = interp.affine_warp(q, res, ("rot", angle), axis_x=2, axis_y=3)
        with span("bs:svd"):
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
        if not isinstance(angle, torch.Tensor) and np.ndim(angle) != 0:
            angle = np.asarray(angle, np.float64)
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


def _phase(t):
    """exp(i t) of an angle: a complex128 tensor for a tensor, else a
    Python complex."""
    return torch.exp(1j * t.double()) if isinstance(t, torch.Tensor) else complex(np.exp(1j * t))


def _bits(mu: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 parities of round((re mu, im mu) / sqrt(pi))."""
    vec = torch.stack([mu.real, mu.imag], -1)
    return torch.round(vec / SQPI).to(torch.int32) % 2


def _syndrome_from_device(ta, tb, ma: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`_syndrome_from`: (B, 2) int32 on the outcomes'
    device, in float64; the angles are numbers or (B,) tensors."""
    ma, mb = ma.double(), mb.double()
    diff = ta - tb
    sin = torch.sin(diff.double()) if isinstance(diff, torch.Tensor) else float(np.sin(diff))
    mu = 1j * (ma * _phase(tb) + mb * _phase(ta)) / sin
    return _bits(mu * 2**0.5)


def _two_mode_syndromes_device(mb2type: MB2Type, ms) -> torch.Tensor:
    """Device twin of :func:`_two_mode_syndromes`: (B, 2, 2) int32 on the
    outcomes' device."""
    ta, tc, tb, td = mb2type.angles()
    ma, mb, mc, md = (m.double() for m in ms)
    mu_ab = 1j * (ma * _phase(tb) + mb * _phase(ta)) / float(np.sin(ta - tb))
    mu_cd = 1j * (mc * _phase(td) + md * _phase(tc)) / float(np.sin(tc - td))
    return torch.stack([_bits(mu_cd + mu_ab), _bits(mu_cd - mu_ab)], 1)


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
                   opts: SVDOptions, generator, qs, *, a1_zero: bool = True,
                   host: bool = True):
    """Walshe single-mode gadget on a batched chain: Bell insertion, BS
    split, two homodynes. ``meas_angles`` are the measured angles (each a
    number or one per trajectory), ``syn_angles`` those of the syndrome
    formula (they differ for a Pauli-frame-flipped T). Returns (tensors,
    (B, 2) syndromes): host numpy, or with ``host=False`` an int32 tensor
    on the chain's device (no fetch)."""
    tensors = _insert_bell(tensors, idx + 1, bell)
    tensors, _ = _bs_split(tensors, idx, idx + 1, opts, generator, qs)
    tensors, m_a = _homodyne(tensors, idx, meas_angles[0], generator, qs,
                             static_zero=a1_zero)
    tensors, m_b = _homodyne(tensors, idx, meas_angles[1], generator, qs)
    if not host:
        return tensors, _syndrome_from_device(syn_angles[0], syn_angles[1], m_a, m_b)
    ms = fetch(torch.stack([m_a, m_b], -1)).numpy()
    return tensors, _syndrome_from(syn_angles[0], syn_angles[1], ms[:, 0], ms[:, 1])


def _two_mode_gadget(tensors, idx: int, mb2type: MB2Type, bell: torch.Tensor,
                     opts: SVDOptions, generator, qs, *, host: bool = True):
    """Macronode two-mode gadget (static angles) on a batched chain: two
    Bell insertions (``bell``, coefficient 1), four BS splits, four
    homodynes. Returns (tensors, (B, 2, 2) syndromes): host numpy, or with
    ``host=False`` an int32 tensor on the chain's device."""
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
    if not host:
        return tensors, _two_mode_syndromes_device(mb2type, (m_a, m_b, m_c, m_d))
    ms = fetch(torch.stack([m_a, m_b, m_c, m_d])).numpy()
    return tensors, _two_mode_syndromes(mb2type, ms)


class CompiledGKP:
    """Whole-circuit trajectory program for a transpiled
    :class:`.transpiler.MBGKPCircuit`, over a batch of trajectories.

    >>> prog = CompiledGKP(circuit, qs, epsilon, svd_options)
    >>> tensors, frames = prog.batched(init_mps, 16, rng_seed=0)
    >>> frames, rho_re, rho_im = prog.batched_readout(logical_coeffs(states), 16)

    The counterpart of the JAX package's ``jit(vmap(trajectory))``: the
    chain carries a leading trajectory axis and lives on ``device``
    (default ``cuda``); every bond keeps its static cap with truncated
    directions zero-masked; outcomes and sketches are drawn from one host
    ``torch.Generator`` per call. Classical control selects parameters,
    not structure: the controlled P/Pdg-versus-I gadget is one gadget
    whose second homodyne angle is a device tensor, and the frame's T/Tdg
    flip is a device sign in the Bell coefficient.
    """

    def __init__(self, circuit: MBGKPCircuit, qs, ancilla_epsilon,
                 svd_options: SVDOptions | dict | None = None, *, device=None):
        self.circuit = circuit
        self.qs = np.asarray(qs)
        self.epsilon = ancilla_epsilon
        if isinstance(svd_options, dict):
            svd_options = SVDOptions(**svd_options)
        self.opts = svd_options or SVDOptions()
        self.N = circuit._N
        self.device = resolve_device(device)
        self._basis: tuple[torch.Tensor, torch.Tensor] | None = None

    def _gkp_basis(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._basis is None:
            self._basis = gkp_basis(_grid(self.qs, self.device), float(self.epsilon))
        return self._basis

    # -- frame arithmetic on the device ------------------------------------
    @staticmethod
    def _commute_frame(gate, frame: torch.Tensor) -> torch.Tensor:
        """Pauli-frame update for a static gate type; ``frame`` is a (..., N,
        2) int32 tensor (x, z bits per qubit). Returns a new tensor."""
        t = type(gate)
        frame = frame.clone()
        if t is dv_gates.H:
            i = gate.indices[0]
            frame[..., i, :] = frame[..., i, :].flip(-1)
        elif t in (dv_gates.P, dv_gates.Pdg):
            i = gate.indices[0]
            frame[..., i, 1] ^= frame[..., i, 0]
        elif t is dv_gates.CZ:
            i, j = gate.indices
            zi = frame[..., i, 1] ^ frame[..., j, 0]
            zj = frame[..., j, 1] ^ frame[..., i, 0]
            frame[..., i, 1], frame[..., j, 1] = zi, zj
        elif t is dv_gates.SWAP:
            i, j = gate.indices
            fi = frame[..., i, :].clone()
            frame[..., i, :] = frame[..., j, :]
            frame[..., j, :] = fi
        return frame

    # -- the program -------------------------------------------------------
    def trajectory(self, init_tensors: list[torch.Tensor], rng_seed=None):
        """Run every trajectory of a batched initial chain, (B, l, d, r)
        tensors on the program's device, through the whole circuit.
        Returns (tensors, frames (B, N, 2) int32 on the device)."""
        tensors = [t.to(self.device) for t in init_tensors]
        generator = as_generator(rng_seed)
        B, N, dev = tensors[0].shape[0], self.N, self.device
        opts, qs = self.opts, self.qs
        dtype = tensors[0].dtype
        basis = self._gkp_basis()
        bell_one = bell_vectors(basis, torch.ones(B, dtype=torch.complex128, device=dev), dtype)
        layers = self.circuit._layers
        paulis = to_device(np.asarray([layer.paulis for layer in layers], np.int32), dev)
        half_pi = torch.full((B,), np.pi / 2, dtype=torch.float64, device=dev)

        def single(idx, meas, syn, bell, a1_zero=True):
            nonlocal tensors
            tensors, synd = _single_gadget(tensors, idx, meas, syn, bell, opts,
                                           generator, qs, a1_zero=a1_zero, host=False)
            cur_synd[:, idx] = synd

        frame = torch.zeros((B, N, 2), dtype=torch.int32, device=dev)
        prev_synd = torch.zeros_like(frame)  # the previous layer's gadget syndromes
        for k, layer in enumerate(layers):
            cur_synd = torch.zeros_like(frame)
            for gate in layer.gates:
                if isinstance(gate, ClassicalControl):
                    # controlled P/Pdg vs I: a device angle selection
                    idx = gate.gate.indices[0]
                    cond = prev_synd[:, idx, 0]
                    p_angle = -ARCTAN2 if isinstance(gate.gate, dv_gates.Pdg) else ARCTAN2
                    angle2 = torch.where(cond == 1, half_pi.new_full((B,), p_angle), half_pi)
                    # frame: P/Pdg set z ^= x only when triggered
                    frame[:, idx, 1] ^= cond & frame[:, idx, 0]
                    single(idx, (0.0, angle2), (0.0, angle2), bell_one)
                    continue

                t = type(gate)
                if t in (dv_gates.T, dv_gates.Tdg):
                    idx = gate.indices[0]
                    # the Pauli frame flips T <-> Tdg: a device sign
                    base = half_pi.new_full((B,), -1.0 if t is dv_gates.Tdg else 1.0)
                    sgn = torch.where(frame[:, idx, 0] == 1, -base, base)
                    bell = bell_vectors(basis, torch.exp(1j * np.pi / 8 * sgn), dtype)
                    # measured at the plain I-angles; the syndrome formula
                    # takes the dagger-signed ones (reference parity)
                    single(idx, (0.0, np.pi / 2), (0.0, sgn * np.pi / 2), bell)
                    continue

                frame = self._commute_frame(gate, frame)
                if t is dv_gates.I:
                    single(gate.indices[0], (0.0, np.pi / 2), (0.0, np.pi / 2), bell_one)
                elif t is dv_gates.H:
                    angles = (np.pi / 4, -np.pi / 4)
                    single(gate.indices[0], angles, angles, bell_one, a1_zero=False)
                elif t in (dv_gates.P, dv_gates.Pdg):
                    angle2 = -ARCTAN2 if t is dv_gates.Pdg else ARCTAN2
                    single(gate.indices[0], (0.0, angle2), (0.0, angle2), bell_one)
                elif t in (dv_gates.CZ, dv_gates.SWAP):
                    idx = min(gate.indices)
                    kind = MB2Type.CZ if t is dv_gates.CZ else MB2Type.SWAP
                    tensors, synd = _two_mode_gadget(tensors, idx, kind, bell_one, opts,
                                                     generator, qs, host=False)
                    cur_synd[:, idx:idx + 2] = synd
                else:
                    raise NotImplementedError(f"Gate {gate} not supported in compiled mode.")

            # end of layer: fold the gadget syndromes and scheduled Paulis
            frame = frame ^ cur_synd ^ paulis[k]
            prev_synd = cur_synd

        return tensors, frame

    def batched(self, init_mps, n: int, rng_seed=None):
        """Run ``n`` trajectories from one initial MPS (its tensors
        broadcast over the batch); returns (tensors (n, l, d, r), frames
        (n, N, 2))."""
        init = [t.to(self.device)[None].expand(n, *t.shape).contiguous()
                for t in init_mps.tensors]
        return self.trajectory(init, rng_seed)

    # -- entry point from logical coefficients to the corrected rho ---------
    def trajectory_with_readout(self, init_coeffs, rng_seed=None, *, n: int | None = None):
        """Trajectories from logical initial coefficients to the corrected
        logical density. ``init_coeffs`` is (N, 2, 2): per mode
        [[a_re, a_im], [b_re, b_im]] of the GKP state a|0> + b|1>. Returns
        (frame (N, 2), rho_re, rho_im (2^N, 2^N)) of one trajectory, or
        with ``n`` the batch (n, ...): real and int tensors on the device,
        the rho raw (not trace-normalised, the reference's convention)."""
        batch = 1 if n is None else n
        dtype = complex_dtype(self.device)
        tensors = product_tensors(self._gkp_basis(), init_coeffs, self.qs, batch, dtype)
        out, frames = self.trajectory(tensors, rng_seed)
        rho_re, rho_im = corrected_density(out, frames, self.qs)
        if n is None:
            return frames[0], rho_re[0], rho_im[0]
        return frames, rho_re, rho_im

    def batched_readout(self, init_coeffs, n: int, rng_seed=None):
        """``n`` trajectories -> (frames (n, N, 2), rho_re, rho_im (n, 2^N,
        2^N)); the coefficients are taken in float32, as in the JAX
        package."""
        coeffs = np.asarray(init_coeffs, dtype=np.float32)
        return self.trajectory_with_readout(coeffs, rng_seed, n=n)


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
