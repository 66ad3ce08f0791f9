"""GKP error-correction analysis on the position grid (counterpart of
``quantum_computations_tpu/pipelines/gkp_ec.py``).

The Steane-type projector as an FFT linear convolution, the symmetric
(Knill/teleportation) Bell-kernel projector, the dense-grid logical
density matrix (the reference's fixed 10-term operator sum) and
``logical_fidelity``, on tensors on the caller's device. The operator
tables are formed on the host in float64 and cast to the device's complex
dtype (``config.complex_dtype``) when they meet the state. The plotting
helpers are host code; ``matplotlib`` is imported when one is called.

The grid conventions are the reference's and differ on purpose: here
``dq = (q[-1] - q[0]) / n``, where :mod:`.gkp_ec_validation`'s
Knill–Steane check and the grid normalisation use ``/ (n - 1)``.
"""

from __future__ import annotations

import math
from itertools import product as iprod

import numpy as np
import torch

from ..config import complex_dtype, full_fp32_matmul, to_device
from ..cv.states import comb_sym, gkp_sym  # noqa: F401  (the JAX module's surface)
from ..ops.interp import whittaker_shannon

PI = np.pi
SQPI = np.sqrt(np.pi)


def _grid(qs, like: torch.Tensor) -> torch.Tensor:
    """The grid as float64 on ``like``'s device."""
    return torch.as_tensor(qs, dtype=torch.float64, device=like.device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def normalise(qs, state: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.trapezoid((state * torch.conj(state)).real,
                                      _grid(qs, state)))
    return state / norm


def fourier(qs, state: torch.Tensor) -> torch.Tensor:
    """Single-axis continuous FT evaluated back on ``qs`` (reference
    :29-45): an FFT, then a d x d sinc interpolation."""
    qs = _grid(qs, state)
    N = state.shape[0]
    T = (qs[-1] - qs[0]) * N / (N - 1)
    ps = torch.fft.fftshift(torch.fft.fftfreq(
        N, dtype=torch.float64, device=state.device) * (N * 2 * PI / T))
    fs = torch.fft.fftshift(torch.fft.fft(state))
    phase = T / (N * math.sqrt(2 * PI)) * torch.exp(-1j * ps * qs[0])
    fs = fs * phase.to(fs.dtype)
    new_ps = torch.remainder(qs - ps[-1], ps[-1] - ps[0]) + ps[0]
    return whittaker_shannon(ps, fs, new_ps)


def gkp_project_asym(qs, state: torch.Tensor, zero: torch.Tensor,
                     axis: int = 0) -> torch.Tensor:
    """Steane-type EC projector: multiply by <+| on the ancilla quadrature
    and convolve with the |0> comb (scipy's 'same'-mode linear
    convolution, as an FFT product of length 2^ceil(log2(2n - 1)))."""
    q = _grid(qs, state)
    dq = (q[-1] - q[0]) / q.shape[0]
    plus = fourier(qs, zero)
    state = torch.movedim(state, axis, 0)
    bcast = (-1,) + (1,) * (state.ndim - 1)
    state = state * plus.reshape(bcast)

    n = state.shape[0]
    full = 2 * n - 1
    fft_len = int(2 ** np.ceil(np.log2(full)))
    sf = torch.fft.fft(state, n=fft_len, dim=0)
    zf = torch.fft.fft(zero, n=fft_len).reshape(bcast)
    conv = torch.fft.ifft(sf * zf, dim=0)[:full]
    start = (full - n) // 2
    state = conv[start:start + n] * dq
    return torch.movedim(state, 0, axis)


@full_fp32_matmul()
def gkp_project_sym(qs, state: torch.Tensor, zero: torch.Tensor, one: torch.Tensor,
                    axis: int = 0) -> torch.Tensor:
    """Symmetric (Knill/teleportation) projector via the Bell kernel."""
    q = _grid(qs, state)
    dq = (q[-1] - q[0]) / q.shape[0]
    bell = (torch.outer(zero, zero) + torch.outer(one, one)) * 2**-0.5
    state = torch.tensordot(bell, state, dims=([1], [axis])) * dq / math.sqrt(2 * PI)
    return torch.movedim(state, 0, axis)


def _measurement_operators(qs: np.ndarray, n_terms: int = 10):
    """[I, X, Y, Z] measurement operators (host float64 / complex128 d x d
    tables) with the reference's fixed 10-term sum (range(1, 20, 2),
    reference :77)."""
    qs = np.asarray(qs, np.float64)
    d = len(qs)
    dq = (qs[-1] - qs[0]) / d
    qd = qs[:, None] - qs[None, :]
    Im = np.identity(d)
    Xm = np.zeros((d, d))
    Zm = np.zeros((d, d))
    for n, m in enumerate(range(1, 2 * n_terms, 2)):
        coeff = (-1) ** (n % 2) * 2 / (m * PI)
        Xm += coeff * (np.sinc((qd - m * SQPI) / dq) + np.sinc((qd + m * SQPI) / dq))
        Zm += coeff * np.diag(2 * np.cos(SQPI * m * qs))
    Ym = 1j * Xm @ Zm
    return [Im, Xm, Ym, Zm]


_PAULIS = [np.eye(2), np.array([[0, 1], [1, 0]]),
           np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]])]


@full_fp32_matmul()
def full_logical_density(qs, state: torch.Tensor) -> torch.Tensor:
    """Dense-grid logical density matrix (2^N, 2^N) of an N-mode state
    tensor, on the state's device in its complex dtype."""
    qs = _host(qs).astype(np.float64)
    dq = (qs[-1] - qs[0]) / len(qs)
    dev = state.device
    cdt = complex_dtype(dev)
    Pms = [to_device(np.asarray(p, np.complex128), dev).to(cdt)
           for p in _measurement_operators(qs)]
    state = state.to(cdt)
    N = state.ndim
    bra = torch.conj(state)
    coeffs, paulis = [], []
    for index in iprod(*[[0, 1, 2, 3]] * N):
        ket = state
        for i in range(N):
            ket = torch.tensordot(ket, Pms[index[i]], dims=([0], [1]))
        coeffs.append((dq / 2) ** N * torch.tensordot(bra, ket, dims=N))
        pauli = 1
        for i in index:
            pauli = np.kron(pauli, _PAULIS[i])
        paulis.append(pauli)
    paulis = to_device(np.asarray(paulis, np.complex128), dev).to(cdt)
    return torch.einsum("k,kij->ij", torch.stack(coeffs), paulis)


def logical_fidelity(qs, state: torch.Tensor) -> float:
    rho = full_logical_density(qs, state)
    rho = rho / torch.trace(rho)
    return float(torch.trace(rho @ rho).real)


# -- plotting helpers (reference utils.py:123-209), host code ---------------

def get_tickmarks(lo, hi, alt_labels: bool = False):
    """sqrt(pi)-lattice tick positions and labels for phase-space plots."""
    ns = np.arange(round(lo / SQPI), round(hi / SQPI) + 1, 1)
    ticks = ns * SQPI
    if alt_labels:
        labels = np.array([str(n) for n in ns], dtype=object)
    else:
        labels = []
        for n in ns:
            if n == 0:
                labels.append(r"$0$")
                continue
            prefix = {-1: "-", 1: ""}.get(n, str(n))
            labels.append("$" + prefix + r"\sqrt{\pi}$")
        labels = np.array(labels, dtype=object)
    labels[ns % 2 == 1] = ""
    return ticks, list(labels)


def plot_single_mode(xs, state):
    import matplotlib.pyplot as plt

    xs, state = _host(xs), _host(state)
    fig, ax = plt.subplots(1, 1, figsize=(8, 3))
    ax.plot(xs, np.real(state), "k-", label=r"$\mathrm{Re}(\psi(q))$")
    ax.plot(xs, np.imag(state), "r--", label=r"$\mathrm{Im}(\psi(q))$")
    ax.set_xticks(*get_tickmarks(min(xs), max(xs), True))
    ax.set_xlabel(r"$q/\sqrt{\pi}$")
    ax.legend()
    fig.tight_layout()
    return fig, ax


def plot_two_mode(x, y, state, projections: bool = False):
    import matplotlib.pyplot as plt

    x, y, state = _host(x), _host(y), _host(state)
    fig = plt.figure(figsize=(6, 6))
    if projections:
        gs = fig.add_gridspec(2, 2, width_ratios=(4, 1), height_ratios=(1, 4),
                              left=0.1, right=0.9, bottom=0.1, top=0.9,
                              wspace=0.05, hspace=0.05)
        ax = fig.add_subplot(gs[1, 0])
        ax_x = fig.add_subplot(gs[0, 0], sharex=ax)
        ax_y = fig.add_subplot(gs[1, 1], sharey=ax)
        dx = (x[-1] - x[0]) / len(x)
        dy = (y[-1] - y[0]) / len(y)
        y_int = np.einsum("ij,ij->i", state, state.conj()).real * dy
        x_int = np.einsum("ij,ij->j", state, state.conj()).real * dx
        span = (min(x_int.min(), y_int.min()), max(x_int.max(), y_int.max()))
        width = span[1] - span[0]
        lims = (span[0] - width / 10, span[1] + width / 10)
        ax_x.plot(x, y_int, "k-")
        ax_x.grid(axis="x")
        ax_x.tick_params(axis="x", labelbottom=False)
        ax_x.set_ylim(*lims)
        ax_y.plot(x_int, y, "k-")
        ax_y.grid(axis="y")
        ax_y.tick_params(axis="y", labelleft=False)
        ax_y.set_xlim(*lims)
        axs = [ax, ax_x, ax_y]
    else:
        ax = fig.add_subplot(1, 1, 1)
        axs = ax

    ax.contour(*np.meshgrid(x, y, indexing="ij"), np.abs(state), 10, colors="Black")
    ax.set_xticks(*get_tickmarks(min(x), max(x), True))
    ax.set_xlabel(r"$q_1/\sqrt{\pi}$")
    ax.set_yticks(*get_tickmarks(min(y), max(y), True))
    ax.set_ylabel(r"$q_2/\sqrt{\pi}$")
    ax.grid()
    return fig, axs
