"""Grid transforms of the plain reference: the fractional-Fourier rotation
and the three-shear FFT rotation of a two-mode pair.

Frozen copy of ``quantum_computations_tpu_torch/ops/interp.py`` at commit
6cc9e90 (``rotation``, ``shear_fft``, ``rotate_fft``), with the port's
per-call matmul precision and pinned host copies taken out: the caller of
:func:`..engine.replay_batch` sets the precision for the whole replay.
Every table is formed in float64/complex128 and cast to the state's dtype
last, as in the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f64(x, like: torch.Tensor) -> torch.Tensor:
    """A grid as float64 on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float64, device=like.device)


def spacing(qs: torch.Tensor) -> torch.Tensor:
    return (qs[-1] - qs[0]) / (qs.shape[0] - 1)


def complex_of(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def rotation(qs, tensor: torch.Tensor, theta, axis: int = 0) -> torch.Tensor:
    """Phase-space rotation by ``theta`` along ``axis`` as a dense kernel
    matmul; ``theta`` is a number or one angle per trajectory (axis 0 is
    then the batch)."""
    qs = f64(qs, tensor)
    if not isinstance(theta, torch.Tensor) and np.ndim(theta) == 0:
        theta = float(theta)
        cos, sin = math.cos(theta), math.sin(theta)
    else:
        theta = f64(np.asarray(theta, np.float64) if not isinstance(theta, torch.Tensor)
                    else theta, tensor)[:, None, None]
        cos, sin = torch.cos(theta), torch.sin(theta)
    exponent = cos * ((qs**2)[:, None] + (qs**2)[None, :]) / 2.0 - torch.outer(qs, qs)
    kernel = (2 * math.pi * abs(sin)) ** -0.5 * torch.exp(exponent / (1j * sin))
    kernel = (kernel * spacing(qs)).to(complex_of(tensor.dtype))
    if kernel.ndim == 2:
        res = torch.tensordot(kernel, tensor.to(kernel.dtype), dims=([0], [axis]))
        return torch.movedim(res, 0, axis)
    x = torch.movedim(tensor.to(kernel.dtype), axis, -1)
    res = (x.reshape(x.shape[0], -1, x.shape[-1]) @ kernel).reshape(
        *x.shape[:-1], kernel.shape[-1])
    return torch.movedim(res, -1, axis)


def shear_fft(qs, tensor: torch.Tensor, gain, shear_axis: int,
              coord_axis: int) -> torch.Tensor:
    """Shift along ``shear_axis`` by gain times the coordinate of
    ``coord_axis``, applied exactly in Fourier space."""
    qs = f64(qs, tensor)
    d = qs.shape[0]
    freqs = torch.fft.fftfreq(d, dtype=torch.float64, device=tensor.device) / spacing(qs)
    spec = torch.fft.fft(tensor, dim=shear_axis)
    shape = [1] * tensor.ndim
    shape[shear_axis] = d
    f = freqs.reshape(shape)
    shape = [1] * tensor.ndim
    shape[coord_axis] = d
    delta = (gain * qs).reshape(shape)
    chirp = torch.exp(-2j * math.pi * f * delta).to(spec.dtype)
    return torch.fft.ifft(spec * chirp, dim=shear_axis)


def rotate_fft(qs, tensor: torch.Tensor, angle, axis_x: int, axis_y: int) -> torch.Tensor:
    """Beamsplitter warp out(v) = in(R v), R = [[c, s], [-s, c]], as three
    FFT shears."""
    g_x = -math.tan(angle / 2)
    g_y = math.sin(angle)
    out = shear_fft(qs, tensor, g_x, axis_x, axis_y)
    out = shear_fft(qs, out, g_y, axis_y, axis_x)
    return shear_fft(qs, out, g_x, axis_x, axis_y)
