"""CV gates on the grid-MPS (counterpart of
``quantum_computations_tpu/cv/gates.py``).

Two-mode gates contract the neighbouring pair, apply the grid transform of
:func:`..ops.interp.affine_warp` (FFT shears by default, or the bilinear
gather of :func:`..ops.interp.warp_2d` with ``QCT_WARP=gather``) and split
the (a*d, d*b) matrix by a truncated SVD (:func:`..ops.linalg.tensor_svd`),
then trim the bond to its kept rank on the host.

Above ``_STREAM_THRESHOLD`` elements of the contracted (a, d, d, b)
tensor (``QCT_STREAM_THRESHOLD``, default 2^28) a split with a bond cap
runs streamed (:func:`..ops.streamed.streamed_pair_svd`): the matrix is
never formed. The JAX engine also streams a concrete split with
min(a*d, d*b) > 512 on any backend but the CPU (``_EIGH_SAFE_SIDE``), a
workaround for its TPU's realified-Gram eigh; the port splits through
:func:`..ops.linalg.svd_compat` (LAPACK on the CPU, the float64 Gram eigh
on CUDA) below the threshold on every device and has no such clause.

Stochastic steps draw from one ``torch.Generator``: measurements sample the
outcome with ``torch.multinomial`` over the float64 distribution on the
generator's device, and randomized splits draw their sketches from it.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ..config import SVDOptions, full_fp32_matmul
from ..ops import interp
from ..ops.linalg import tensor_svd, trim_split
from ..ops.streamed import effective_power_iters, streamed_pair_svd
from .gate_abc import Gate, Measurement, MeasurementResult, SingleModeGate, TwoModeGate, REPR_DIGITS
from .mps import MPS
from .states import State

logger = logging.getLogger(__name__)

__all__ = [
    "Insert", "SWAP", "BS", "Mq", "Mp", "Homodyne", "CZ", "CX", "F", "X", "Z",
    "D", "P", "S", "Phase", "Gate", "Measurement", "MeasurementResult",
    "SingleModeGate", "TwoModeGate",
]

# Elements of the contracted (a, d, d, b) tensor above which a two-mode
# split streams instead of materialising the (a*d, d*b) matrix. QCT_WARP
# selects the two-mode transform: "fft" (default, spectrally exact) or
# "gather" (bilinear, scipy's RegularGridInterpolator semantics).
_STREAM_THRESHOLD = int(os.environ.get("QCT_STREAM_THRESHOLD", 1 << 28))
_WARP_BACKEND = os.environ.get("QCT_WARP", "fft")


def _opts(gate: Gate, svd_options: SVDOptions | None) -> SVDOptions:
    return gate.effective_svd_options(svd_options)


def _split(tensor, left, right, opts: SVDOptions, generator):
    m1, m2, rank = tensor_svd(
        tensor, left, right,
        max_bond_dim=opts.max_bond_dim, abs_err=opts.abs_err, rel_err=opts.rel_err,
        generator=generator, svd_method=opts.svd_method,
    )
    return trim_split(m1, m2, rank)


def _use_streamed(a: int, d: int, b: int, opts: SVDOptions) -> bool:
    """True where the split of an (a, d, d, b) pair streams: above the
    threshold, with a bond cap."""
    return opts.max_bond_dim is not None and a * d * d * b > _STREAM_THRESHOLD


@full_fp32_matmul()
def _pair_transform_split(mps, left_index, right_index, warp_params, opts, generator):
    """Contract neighbours, apply the two-mode grid transform, SVD-split —
    materialised, or streamed above the threshold.

    ``warp_params`` is an :func:`..ops.interp.affine_warp` descriptor; for
    ("swap",) the transform exchanges the modes, so the split is the SWAP
    contract-and-resplit.
    """
    t1, t2 = mps[left_index], mps[right_index]
    a, d, _ = t1.shape
    b = t2.shape[-1]
    if _use_streamed(a, d, b, opts):
        cap = min(opts.max_bond_dim, a * d, d * b)
        # the reference power-iteration heuristic, under QCT_STREAM_POWER_ITERS
        q = effective_power_iters(7 if cap + 10 < 0.1 * min(a * d, d * b) else 4)
        m1, m2, rank = streamed_pair_svd(
            t1, t2, mps.qs, warp_params, max_bond_dim=opts.max_bond_dim,
            abs_err=opts.abs_err, rel_err=opts.rel_err, generator=generator,
            power_iters=q)
        mps[left_index], mps[right_index] = trim_split(m1, m2, rank)
        return
    qs = mps.qs
    res = torch.tensordot(t1, t2, dims=([2], [0]))
    if _WARP_BACKEND == "gather" and warp_params[0] in ("rot", "shear"):
        if warp_params[0] == "rot":
            x_src, y_src = interp.rotation_maps(qs, warp_params[1])
        else:
            x_src, y_src = interp.shear_maps(qs, warp_params[1], warp_params[2])
        res = interp.warp_2d(qs, res, x_src, y_src)
    else:
        res = interp.affine_warp(qs, res, warp_params)
    mps[left_index], mps[right_index] = _split(res, (0, 1), (2, 3), opts, generator)


class Insert(SingleModeGate):
    """Insert a fresh CV mode at `index`."""

    def __init__(self, index: int, state: State, *, gkp_epsilon=None, **kwargs):
        if kwargs.pop("dagger", None):
            logger.info(type(self).__name__ + " gates ignore adjoint/dagger.")
        super().__init__(index, arg=state, **kwargs)
        self.gkp_epsilon = gkp_epsilon

    @full_fp32_matmul()
    def apply(self, mps: MPS, *, generator=None, svd_options=None, **_):
        state = self.arg.eval(mps.qs, self.gkp_epsilon, dtype=mps.dtype)
        if self.index < 0 or self.index > len(mps):
            raise IndexError(
                f"Cannot insert mode at index {self.index} for MPS of length {len(mps)}"
            )
        if self.index == 0:
            mps.tensors.insert(0, state.reshape(1, -1, 1))
            return
        if self.index == len(mps):
            mps.tensors.append(state.reshape(1, -1, 1))
            return
        tensor = torch.einsum("i,ajb->aijb", state, mps[self.index])
        m1, m2 = _split(tensor, (0, 1), (2, 3), _opts(self, svd_options), generator)
        mps[self.index] = m2
        mps.tensors.insert(self.index, m1)


class SWAP(TwoModeGate):
    """Swap two neighbouring modes (contract + re-split)."""

    def apply(self, mps: MPS, *, generator=None, svd_options=None, **_):
        _pair_transform_split(mps, self.left_index, self.right_index,
                              ("swap",), _opts(self, svd_options), generator)


class BS(TwoModeGate):
    """Beam splitter: 2-D coordinate rotation of the joint wavefunction."""

    def __init__(self, index1, index2, angle: float = math.pi / 4, **kwargs):
        super().__init__(index1, index2, arg=angle, **kwargs)

    def __repr__(self):
        angle = round(self.arg / math.pi, REPR_DIGITS)
        return type(self).__name__ + f"({angle} * π)" + f"_{self.index1},{self.index2}"

    def apply(self, mps: MPS, *, generator=None, svd_options=None, **_):
        angle = self.arg * (-1) ** (self.index1 > self.index2) * (-1) ** self.dagger
        _pair_transform_split(mps, self.left_index, self.right_index,
                              ("rot", angle), _opts(self, svd_options), generator)


class Mq(Measurement):
    """Homodyne measurement along the q axis.

    ``result`` forces the outcome to the grid point nearest it (first on
    ties); otherwise the outcome is drawn from ``generator``, which reads
    the distribution on its own device (one device sync for a host
    generator and a state on the card).
    """

    @full_fp32_matmul()
    def apply(self, mps: MPS, *, generator=None, **_):
        dq = mps.diff
        rho = mps.partial_density_mps(self.index)
        distribution = torch.clamp(torch.diagonal(rho).real, min=0.0) * dq
        if self.result is None:
            if generator is None:
                raise ValueError("Stochastic homodyne requires a torch.Generator.")
            weights = distribution.to(generator.device, torch.float64)
            s_index = int(torch.multinomial(weights, 1, generator=generator))
        else:
            s_index = int(np.argmin(np.abs(mps.domain - self.result)))
        s = float(mps.domain[s_index])
        p = distribution[s_index] / dq

        if len(mps) == 1:
            # Last remaining mode: record the sample, leave the chain as-is.
            return MeasurementResult(s, p)

        mode = mps[self.index][:, s_index, :]
        # Underflow guard: in float32 a sampled bin's density can denormalise
        # to 0, and 0/0 would poison the whole trajectory with NaNs.
        p_safe = torch.clamp(p, min=torch.finfo(mode.real.dtype).tiny)
        mode = mode / torch.sqrt(p_safe)
        # Contract into whichever neighbour keeps the smaller intermediate
        # (decided by shape alone).
        if int(np.argmax(mode.shape)) == 0 and self.index != 0:
            mps[self.index - 1] = torch.tensordot(mps[self.index - 1], mode, dims=([2], [0]))
        else:
            mps[self.index + 1] = torch.tensordot(mode, mps[self.index + 1], dims=([1], [0]))
        mps.tensors.pop(self.index)
        return MeasurementResult(s, p)


class Mp(Mq):
    """Homodyne along the p axis: inverse Fourier then Mq."""

    def apply(self, mps: MPS, **kwargs):
        mps[self.index] = interp.fourier(mps.qs, mps[self.index], axis=1, inv=True)
        return super().apply(mps, **kwargs)


class Homodyne(Mq):
    """Homodyne along the q axis rotated by `angle` radians."""

    def __init__(self, index, angle, result=None, **kwargs):
        super().__init__(index, result, arg=angle, **kwargs)

    def __repr__(self):
        angle = round(float(self.arg) / math.pi, REPR_DIGITS)
        res = f" = {round(self.result, REPR_DIGITS)}" if isinstance(self.result, float) else ""
        return type(self).__name__ + f"({angle} * π)" + f"_{self.index}" + res

    def apply(self, mps: MPS, **kwargs):
        angle = float(self.arg)
        if np.isclose(np.sin(angle), 0):
            # sin = 0: measure q directly (no rotation kernel at theta = pi)
            # and flip the outcome's sign for theta = pi.
            result = super().apply(mps, **kwargs)
            result.result = result.result * float(np.round(np.cos(angle)))
            return result
        mps[self.index] = interp.rotation(mps.qs, mps[self.index], -angle, axis=1)
        return super().apply(mps, **kwargs)


class CZ(TwoModeGate):
    """Controlled p-displacement with gain `s` (elementwise phase)."""

    def __init__(self, index1, index2, s: float = 1.0, **kwargs):
        super().__init__(index1, index2, arg=s, **kwargs)

    def apply(self, mps: MPS, *, generator=None, svd_options=None, **_):
        s = (-1) ** self.dagger * self.arg
        _pair_transform_split(mps, self.left_index, self.right_index,
                              ("cz", s), _opts(self, svd_options), generator)


class CX(TwoModeGate):
    """Controlled q-displacement with gain `s`."""

    def __init__(self, control, target, s: float = 1.0, **kwargs):
        super().__init__(control, target, arg=s, **kwargs)

    def __repr__(self):
        return Gate.__repr__(self) + f"_{self.index1},{self.index2}"

    def apply(self, mps: MPS, *, generator=None, svd_options=None, **_):
        gain = self.arg * (-1) ** self.dagger
        _pair_transform_split(mps, self.left_index, self.right_index,
                              ("shear", gain, self.index1 < self.index2),
                              _opts(self, svd_options), generator)


class F(SingleModeGate):
    """Fourier gate."""

    def apply(self, mps: MPS, **_):
        mps[self.index] = interp.fourier(mps.qs, mps[self.index], axis=1, inv=self.dagger)


class X(SingleModeGate):
    """q-axis displacement by `s` (Whittaker–Shannon sinc interpolation)."""

    def __init__(self, index, s: float = 1.0, **kwargs):
        super().__init__(index, arg=s, **kwargs)

    def apply(self, mps: MPS, **_):
        new_qs = mps.qs - (-1) ** self.dagger * self.arg
        mps[self.index] = interp.whittaker_shannon(mps.qs, mps[self.index], new_qs, axis=1)


class Z(SingleModeGate):
    """p-axis displacement by `s` (linear phase)."""

    def __init__(self, index, s: float = 1.0, **kwargs):
        super().__init__(index, arg=s, **kwargs)

    def apply(self, mps: MPS, **_):
        phase = torch.exp((-1) ** self.dagger * 1j * self.arg * mps.qs).to(mps.dtype)
        mps[self.index] = mps[self.index] * phase[None, :, None]


class D(SingleModeGate):
    """Quadrature displacement by s = [s_q, s_p]."""

    def __init__(self, index, s, **kwargs):
        if len(s) != 2:
            raise ValueError("s must have exactly 2 elements.")
        super().__init__(index, arg=s, **kwargs)

    def apply(self, mps: MPS, **kwargs):
        X(self.index, (-1) ** self.dagger * self.arg[0]).apply(mps, **kwargs)
        Z(self.index, (-1) ** self.dagger * self.arg[1]).apply(mps, **kwargs)


class P(SingleModeGate):
    """Quadratic phase gate with gain `s`."""

    def __init__(self, index, s: float = 1.0, **kwargs):
        super().__init__(index, arg=s, **kwargs)

    def apply(self, mps: MPS, **_):
        phase = torch.exp((-1) ** self.dagger * 0.5j * self.arg * mps.qs**2).to(mps.dtype)
        mps[self.index] = mps[self.index] * phase[None, :, None]


def _scale_mode(qs, tensor, a, axis: int = 1):
    """(Σ_a ψ)(q) = √a · ψ(a·q) — the unitary 1-D dilation, norm-preserving.

    Always evaluated on the STRETCH side: for a ≤ 1 the direct sample at a·qs
    is a stretch; for a > 1 the identity Σ_a = F⁻¹ Σ_{1/a} F moves the
    stretch into the Fourier domain.
    """
    a = float(a)
    if a == 1.0:
        return tensor
    if a > 1.0:
        tensor = interp.fourier(qs, tensor, axis=axis)
        tensor = _scale_mode(qs, tensor, 1.0 / a, axis=axis)
        return interp.fourier(qs, tensor, axis=axis, inv=True)
    out = interp.whittaker_shannon(qs, tensor, a * qs, axis=axis)
    return out * math.sqrt(a)


class S(SingleModeGate):
    """Squeezing gate: squeezes the `angle`-rotated quadrature by e^{-r}.

    ``S(i, r, 0)`` maps ψ(q) → e^{r/2} ψ(e^{r} q); for general ``angle``
    S(r, φ) = R(φ) · S(r, 0) · R(-φ) with R the :class:`Phase` rotation.
    """

    def __init__(self, index, r: float, angle: float = 0.0, **kwargs):
        super().__init__(index, arg=float(r), **kwargs)
        self.angle = float(angle)

    def __repr__(self):
        return (type(self).__name__
                + f"({round(self.arg, REPR_DIGITS)}, {round(self.angle, REPR_DIGITS)})"
                + f"_{self.index}")

    def apply(self, mps: MPS, **_):
        qs = mps.qs
        r = (-1) ** self.dagger * self.arg
        tensor = mps[self.index]
        if self.angle:
            tensor = _phase_rotate(qs, tensor, -self.angle)
        tensor = _scale_mode(qs, tensor, float(np.exp(r)), axis=1)
        if self.angle:
            tensor = _phase_rotate(qs, tensor, self.angle)
        mps[self.index] = tensor


def _phase_rotate(qs, tensor, theta, axis: int = 1):
    """Phase-space rotation by `theta` with exact sin(θ)=0 fast paths."""
    c, s = np.cos(theta), np.sin(theta)
    if abs(s) < 1e-12:
        # θ ≡ 0 (identity) or θ ≡ π (parity: ψ(q) → ψ(-q), exact on the
        # symmetric grid).
        return tensor if c > 0 else torch.flip(tensor, (axis,))
    return interp.rotation(qs, tensor, theta, axis=axis)


class Phase(SingleModeGate):
    """Single-mode phase-space rotation by `angle` (fractional Fourier).

    ``Phase(i, π/2)`` coincides with the Fourier gate :class:`F`; sin(angle)=0
    points use the exact identity/parity fast paths.
    """

    def __init__(self, index, angle: float, **kwargs):
        super().__init__(index, arg=float(angle), **kwargs)

    def __repr__(self):
        angle = round(self.arg / math.pi, REPR_DIGITS)
        return type(self).__name__ + f"({angle} * π)" + f"_{self.index}"

    def apply(self, mps: MPS, **_):
        theta = (-1) ** self.dagger * self.arg
        mps[self.index] = _phase_rotate(mps.qs, mps[self.index], theta, axis=1)
