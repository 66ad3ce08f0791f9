"""Grid interpolation and continuous-Fourier transforms (counterpart of
``quantum_computations_tpu/ops/interp.py``).

Sinc interpolation and the fractional-Fourier rotation are dense matmuls;
``CFT``/``fourier`` run on ``torch.fft``; the two-mode warps of BS and CX
are FFT shears (default) or one bilinear gather (:func:`warp_2d`).

Precision: every grid table (sinc matrices, rotation kernels, chirps and
the CZ phase) is formed in float64/complex128 on the state's device and
cast to the state's dtype only when it multiplies the state. On the
d = 1000, [-20, 20] grid those phases reach hundreds to thousands of
radians, which float32 would carry with an error near 1e-4 rad.

Angles and gains are host scalars (Python numbers), and the grid's
spacing is computed on the grid's device: no function here moves a value
between the host and the device, so none of them waits for the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import full_fp32_matmul, to_device


def _f64(x, like: torch.Tensor) -> torch.Tensor:
    """A grid as float64 on ``like``'s device (no copy if it already is)."""
    return torch.as_tensor(x, dtype=torch.float64, device=like.device)


def _spacing(qs: torch.Tensor) -> torch.Tensor:
    return (qs[-1] - qs[0]) / (qs.shape[0] - 1)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype a table must have to multiply a `dtype` tensor."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


@full_fp32_matmul()
def whittaker_shannon(xs, ys: torch.Tensor, new_xs, axis: int = 0) -> torch.Tensor:
    """Sinc (band-limited) interpolation along `axis`, as a dense matmul."""
    xs, new_xs = _f64(xs, ys), _f64(new_xs, ys)
    dx = _spacing(xs)
    sinc = torch.sinc((new_xs[:, None] - xs[None, :]) / dx).to(ys.dtype)
    res = torch.tensordot(sinc, ys, dims=([1], [axis]))
    return torch.movedim(res, 0, axis)


interpolate = whittaker_shannon


@full_fp32_matmul()
def rotation(qs, tensor: torch.Tensor, theta, axis: int = 0, new_qs=None) -> torch.Tensor:
    """Fractional-Fourier (phase-space rotation) by `theta` along `axis`,
    a dense rotated-eigenstate kernel matmul; needs sin(theta) != 0.

    ``theta`` is a number, or one angle per trajectory (a 1-D array or
    tensor of length ``tensor.shape[0]``, the batch axis; ``axis`` >= 1):
    each trajectory is then rotated by its own angle.
    """
    qs = _f64(qs, tensor)
    new_qs = qs if new_qs is None else _f64(new_qs, tensor)
    if not isinstance(theta, torch.Tensor) and np.ndim(theta) == 0:
        theta = float(theta)
        cos, sin = math.cos(theta), math.sin(theta)
    else:
        if not isinstance(theta, torch.Tensor):
            theta = to_device(np.asarray(theta, np.float64), tensor.device)
        theta = _f64(theta, tensor)[:, None, None]
        cos, sin = torch.cos(theta), torch.sin(theta)
    exponent = (
        cos * ((qs**2)[:, None] + (new_qs**2)[None, :]) / 2.0
        - torch.outer(qs, new_qs)
    )
    kernel = (2 * math.pi * abs(sin)) ** -0.5 * torch.exp(exponent / (1j * sin))
    kernel = (kernel * _spacing(qs)).to(_complex_of(tensor.dtype))
    if kernel.ndim == 2:
        res = torch.tensordot(kernel, tensor.to(kernel.dtype), dims=([0], [axis]))
        return torch.movedim(res, 0, axis)
    x = torch.movedim(tensor.to(kernel.dtype), axis, -1)
    res = (x.reshape(x.shape[0], -1, x.shape[-1]) @ kernel).reshape(
        *x.shape[:-1], kernel.shape[-1])
    return torch.movedim(res, -1, axis)


def CFT(qs, tensor: torch.Tensor, axis: int = 0):
    """Continuous quantum Fourier transform via FFT.

    F(p) = (2 pi)^{-1/2} \\int dq f(q) e^{-ipq}; returns (ps, transformed).
    """
    qs = _f64(qs, tensor)
    N = tensor.shape[axis]
    T = (qs[-1] - qs[0]) * N / (N - 1)
    ps = torch.fft.fftshift(torch.fft.fftfreq(
        N, dtype=torch.float64, device=tensor.device) * (N * 2 * math.pi / T))
    fs_hat = torch.fft.fftshift(torch.fft.fft(tensor, dim=axis), dim=axis)
    phase = T / (N * math.sqrt(2 * math.pi)) * torch.exp(-1j * ps * qs[0])
    dims = [1] * fs_hat.ndim
    dims[axis] = -1
    return ps, fs_hat * phase.to(fs_hat.dtype).reshape(dims)


def iCFT(qs, tensor: torch.Tensor, axis: int = 0):
    ps, fs_hat = CFT(qs, tensor, axis=axis)
    return torch.flip(-ps, (0,)), torch.flip(fs_hat, (axis,))


def fourier(qs, tensor: torch.Tensor, axis: int = 0, ps=None, inv: bool = False) -> torch.Tensor:
    """Fourier *gate*: F|psi> = |F^{-1}[psi]>, evaluated back on grid `ps`
    (default `qs`) with Nyquist-periodic wrap + sinc re-interpolation."""
    qs = _f64(qs, tensor)
    ps = qs if ps is None else _f64(ps, tensor)
    _ps, res = iCFT(qs, tensor, axis=axis) if not inv else CFT(qs, tensor, axis=axis)
    ps = torch.remainder(ps - _ps[-1], _ps[-1] - _ps[0]) + _ps[0]
    return whittaker_shannon(_ps, res, ps, axis=axis)


@full_fp32_matmul()
def wigner(qs, state: torch.Tensor, ps=None):
    """Wigner function of a grid wavefunction.

    W(q, p) = (1/pi) \\int dy psi*(q+y) psi(q-y) e^{2ipy}, by a dense
    phase-kernel contraction over the grid. Returns (ps, W) with W of shape
    (len(qs), len(ps)).
    """
    state = torch.as_tensor(state)
    qs = _f64(qs, state)
    ps = qs if ps is None else _f64(ps, state)
    d = qs.shape[0]
    dq = _spacing(qs)
    ys = (torch.arange(d, dtype=torch.float64, device=state.device) - d // 2) * dq

    iq = torch.arange(d, device=state.device)[:, None]
    iy = (torch.arange(d, device=state.device) - d // 2)[None, :]
    ip = iq + iy
    im = iq - iy
    valid = (ip >= 0) & (ip < d) & (im >= 0) & (im < d)
    ip = torch.clamp(ip, 0, d - 1)
    im = torch.clamp(im, 0, d - 1)
    corr = torch.conj(state)[ip] * state[im] * valid  # (q, y)

    phase = torch.exp(2j * torch.outer(ys, ps)).to(_complex_of(corr.dtype))  # (y, p)
    W = torch.tensordot(corr.to(phase.dtype), phase, dims=([1], [0])) * dq / math.pi
    return ps, W.real


def warp_2d(qs, tensor: torch.Tensor, x_src, y_src,
            chunk_elements: int = 1 << 25) -> torch.Tensor:
    """Bilinear resample of the two middle axes of an (a, d, d, b) tensor.

    out[a, i, j, b] = T(a, x_src[i,j], y_src[i,j], b) with linear
    interpolation and zero fill outside the domain (scipy's
    ``RegularGridInterpolator(method='linear', fill_value=0)`` per (a, b)
    slice). Large tensors run in sequential chunks over the leading bond
    axis, so the four gather temporaries stay bounded.
    """
    a = tensor.shape[0]
    total = math.prod(tensor.shape)
    if total > chunk_elements and a > 1:
        n_chunks = 1
        for cand in range(2, a + 1):
            if a % cand == 0 and total // cand <= chunk_elements:
                n_chunks = cand
                break
        if n_chunks > 1:
            return torch.cat([_warp_2d_core(qs, tc, x_src, y_src)
                              for tc in tensor.chunk(n_chunks, 0)], 0)
    return _warp_2d_core(qs, tensor, x_src, y_src)


def _warp_2d_core(qs, tensor: torch.Tensor, x_src, y_src) -> torch.Tensor:
    qs = _f64(qs, tensor)
    x_src, y_src = _f64(x_src, tensor), _f64(y_src, tensor)
    d = qs.shape[0]
    q0 = qs[0]
    dq = _spacing(qs)

    fx = (x_src - q0) / dq
    fy = (y_src - q0) / dq
    inside = (fx >= 0) & (fx <= d - 1) & (fy >= 0) & (fy <= d - 1)

    fx = torch.clamp(fx, 0.0, d - 1.0)
    fy = torch.clamp(fy, 0.0, d - 1.0)
    ix0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, d - 2)
    iy0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, d - 2)
    real = tensor.real.dtype if tensor.is_complex() else tensor.dtype
    wx = (fx - ix0).to(real)[None, :, :, None]
    wy = (fy - iy0).to(real)[None, :, :, None]

    t00 = tensor[:, ix0, iy0, :]
    t01 = tensor[:, ix0, iy0 + 1, :]
    t10 = tensor[:, ix0 + 1, iy0, :]
    t11 = tensor[:, ix0 + 1, iy0 + 1, :]
    out = (
        t00 * (1 - wx) * (1 - wy)
        + t01 * (1 - wx) * wy
        + t10 * wx * (1 - wy)
        + t11 * wx * wy
    )
    return out * inside[None, :, :, None]


def rotation_maps(qs, angle):
    """Source-coordinate grids for the BS rotation (x, y) -> (c x + s y, -s x + c y)."""
    qs = torch.as_tensor(qs, dtype=torch.float64)
    x, y = torch.meshgrid(qs, qs, indexing="ij")
    c, s = math.cos(angle), math.sin(angle)
    return c * x + s * y, -s * x + c * y


def shear_maps(qs, gain, control_left: bool):
    """Source-coordinate grids for the CX controlled displacement."""
    qs = torch.as_tensor(qs, dtype=torch.float64)
    x, y = torch.meshgrid(qs, qs, indexing="ij")
    if control_left:
        return x, y - gain * x
    return x - gain * y, y


def rotate_2d(qs, tensor: torch.Tensor, angle) -> torch.Tensor:
    """BS action: resample middle axes at the rotated coordinates."""
    x_src, y_src = rotation_maps(_f64(qs, tensor), angle)
    return warp_2d(qs, tensor, x_src, y_src)


def shear_2d(qs, tensor: torch.Tensor, gain, control_left: bool) -> torch.Tensor:
    """CX action: controlled displacement."""
    x_src, y_src = shear_maps(_f64(qs, tensor), gain, control_left)
    return warp_2d(qs, tensor, x_src, y_src)


# ---------------------------------------------------------------------------
# FFT-based affine warps (gather-free)
# ---------------------------------------------------------------------------
#
# Every two-mode warp is affine: the beamsplitter is a 2-D rotation, CX a
# shear. A shear along one grid axis is a per-slice constant shift, which
# the FFT applies exactly: multiply the spectrum by exp(-2 pi i f delta). A
# rotation is three shears, R(theta) = ShearX(-tan(theta/2)) .
# ShearY(sin(theta)) . ShearX(-tan(theta/2)). The FFT wraps periodically
# where the gather zero-fills; for wavefunctions supported well inside the
# domain the difference is negligible.

def shear_fft(qs, tensor: torch.Tensor, gain, shear_axis: int,
              coord_axis: int) -> torch.Tensor:
    """out[..., i_c, ..., i_s, ...] = in evaluated at x_s - gain * x_c:
    shift along `shear_axis` by gain * (coordinate of `coord_axis`)."""
    qs = _f64(qs, tensor)
    d = qs.shape[0]
    freqs = torch.fft.fftfreq(d, dtype=torch.float64,
                              device=tensor.device) / _spacing(qs)  # cycles per unit length

    spec = torch.fft.fft(tensor, dim=shear_axis)
    shape = [1] * tensor.ndim
    shape[shear_axis] = d
    f = freqs.reshape(shape)
    shape = [1] * tensor.ndim
    shape[coord_axis] = d
    delta = (gain * qs).reshape(shape)
    chirp = torch.exp(-2j * math.pi * f * delta).to(spec.dtype)
    return torch.fft.ifft(spec * chirp, dim=shear_axis)


def rotate_fft(qs, tensor: torch.Tensor, angle, axis_x: int = 1,
               axis_y: int = 2) -> torch.Tensor:
    """Rotation warp out(v) = in(R v), R = [[c, s], [-s, c]] (the
    ``rotation_maps`` convention), via three FFT shears."""
    g_x = -math.tan(angle / 2)
    g_y = math.sin(angle)
    out = shear_fft(qs, tensor, g_x, axis_x, axis_y)
    out = shear_fft(qs, out, g_y, axis_y, axis_x)
    return shear_fft(qs, out, g_x, axis_x, axis_y)


def affine_warp(qs, tensor: torch.Tensor, params: tuple, axis_x: int = 1,
                axis_y: int = 2) -> torch.Tensor:
    """Dispatch a two-mode grid transform described by ``params``:

    ("rot", angle)                — beamsplitter rotation (3 FFT shears)
    ("shear", gain, control_left) — CX controlled displacement (1 FFT shear)
    ("cz", s)                     — CZ phase exp(i s q_x q_y) (elementwise)
    ("swap",)                     — mode exchange (middle-axis transpose)
    ("id",)                       — no-op (plain contraction)
    """
    kind = params[0]
    if kind == "rot":
        return rotate_fft(qs, tensor, params[1], axis_x, axis_y)
    if kind == "shear":
        gain, control_left = params[1], params[2]
        if control_left:
            return shear_fft(qs, tensor, gain, axis_y, axis_x)
        return shear_fft(qs, tensor, gain, axis_x, axis_y)
    if kind == "cz":
        qs = _f64(qs, tensor)
        d = qs.shape[0]
        phase = torch.exp(1j * params[1] * torch.outer(qs, qs))
        shape = [1] * tensor.ndim
        shape[axis_x], shape[axis_y] = d, d
        return tensor * phase.to(_complex_of(tensor.dtype)).reshape(shape)
    if kind == "swap":
        return torch.swapaxes(tensor, axis_x, axis_y)
    if kind == "id":
        return tensor
    raise ValueError(f"unknown affine warp {params!r}")
