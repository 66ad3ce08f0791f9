"""Plain reference of a batch of GKP trajectories: transpile, replay, read out.

Given the DV gate list of a circuit, its initial logical coefficients, the
grid, the squeezing and the truncation settings, and the draws the timed
run made (every homodyne's grid index and every range-finder sketch, in
the run's order: :class:`Tape`), :func:`replay_batch` works the whole batch
out again and returns the syndrome-corrected logical densities and the
Pauli frames.

It is a frozen copy of the production path of the port at commit 6cc9e90:
``gkp/transpiler.MBGKPCircuit`` (layering, Pauli frames, the classically
controlled P after a T), ``gkp/batched.BatchedGKP`` with
``adaptive=True, granularity="op"`` and fused singles, fused pairs and host
rank tracking (bucketed batch-maximum trims), ``gkp/compiled`` (Bell
vectors and the exact splice, the materialised beamsplitter split by three
FFT shears and a randomized SVD, the syndrome decoding, the frame
correction), ``gkp/utils.logical_density_batch`` and the GKP states of
``cv/states`` with ``ops/theta``. It imports nothing of the port. A split
the port would stream (more than 2^28 elements of the contracted pair)
has no copy here: :func:`replay_batch` raises, and the run is not correct.
"""

from __future__ import annotations

import contextlib
import math
from bisect import insort

import numpy as np
import torch

from .fused import fused_pair_measure2, fused_single_gadget
from .interp import rotate_fft
from .linalg import split_pair

SQPI = math.sqrt(math.pi)
ARCTAN2 = float(np.arctan(2))
STREAM_THRESHOLD = 1 << 28

_PAULI_FRAME = {"X": (1, 0), "Y": (1, 1), "Z": (0, 1)}
_IMPLEMENTABLE = ("I", "H", "P", "Pdg", "T", "Tdg", "CZ", "SWAP")
# (a, c, b, d) homodyne angles of the macronode gadgets
_TWO_MODE_ANGLES = {
    "CZ": (0.0, 0.0, ARCTAN2, -ARCTAN2),
    "SWAP": (-math.pi / 2, 0.0, 0.0, -math.pi / 2),
}


# -- transpiler ---------------------------------------------------------------
class _Layer:
    def __init__(self, N: int):
        self.N = N
        self.occupied = [False] * N
        self.gates: list[tuple[str, tuple[int, ...]]] = []
        self.paulis = [[0, 0] for _ in range(N)]

    def has_gate(self, i: int) -> bool:
        return any(i in idx for _, idx in self.gates)

    def add(self, gate) -> None:
        if any(self.occupied[i] or self.paulis[i] != [0, 0] for i in gate[1]):
            return
        self.insert(gate)

    def insert(self, gate) -> None:
        for i in gate[1]:
            self.occupied[i] = True
        insort(self.gates, gate, key=lambda g: min(g[1]))


def transpile(gates, N: int) -> list[_Layer]:
    """Layers of the measurement-based circuit of a DV gate list
    ``[(name, indices), ...]``, filled with identity gadgets. A T (Tdg)
    schedules a classically controlled P (Pdg), named ``"cP"`` (``"cPdg"``)."""
    layers = [_Layer(N)]
    next_free = [0] * N

    def schedule(gate):
        at = max(next_free[i] for i in gate[1])
        while at >= len(layers):
            layers.append(_Layer(N))
        layers[at].add(gate)
        for i in gate[1]:
            next_free[i] = at + 1

    for name, idx in gates:
        idx = tuple(int(i) for i in idx)
        if any(i < 0 or i >= N for i in idx) or len(idx) > 2 or (
                len(idx) == 2 and abs(idx[0] - idx[1]) != 1):
            raise ValueError(f"cannot place {name}{idx} on {N} modes")
        if name in _PAULI_FRAME:
            q = idx[0]
            at = max(next_free[q] - 1, 0)
            layer = layers[at]
            for k in (0, 1):
                layer.paulis[q][k] = (layer.paulis[q][k] + _PAULI_FRAME[name][k]) % 2
            next_free[q] = at if (layer.paulis[q] == [0, 0] and not layer.occupied[q]) else at + 1
        elif name in _IMPLEMENTABLE:
            schedule((name, idx))
            if name in ("T", "Tdg"):
                schedule(("cP" if name == "T" else "cPdg", idx))
        else:
            raise ValueError(f"{name} is not implementable")
    for layer in layers:
        for i in range(N):
            if not layer.has_gate(i):
                layer.insert(("I", (i,)))
    return layers


# -- states ---------------------------------------------------------------------
def _theta3(z: torch.Tensor, tau, terms: int = 64) -> torch.Tensor:
    n = torch.arange(1, terms + 1, dtype=torch.float64, device=z.device)
    qn = torch.exp(1j * math.pi * tau * n**2)
    return 1.0 + 2.0 * torch.sum(qn * torch.cos(2 * math.pi * z[..., None] * n), dim=-1)


def _gkp(q: torch.Tensor, epsilon: float, logical: int) -> torch.Tensor:
    """Grid-normalised finite-energy GKP |logical> (symmetric form)."""
    env = torch.exp(-math.tanh(epsilon) * q**2 / 2)
    tau = 1j * math.tanh(epsilon) / 2
    z = (-q / (2 * SQPI * math.cosh(epsilon))).to(torch.complex128) + logical / 2
    psi = env * _theta3(z, tau)
    dq = torch.abs(q[-1] - q[0]) / (q.shape[0] - 1)
    return psi / torch.sqrt(torch.sum(psi * torch.conj(psi)).real * dq)


def db2eps(db: float) -> float:
    return float(2.0 * np.arctanh(np.float_power(10.0, -np.asarray(db) / 10.0) / 2.0))


# -- the engine ------------------------------------------------------------------
class Tape:
    """The draws of one batch of the timed run, replayed in its order:
    ``indices`` one (B,) integer array per homodyne; ``sketches`` one
    (generator state, n, l, float32) per trajectory's range-finder draw:
    the float64 (n, l) normal draw of a host generator in that state,
    rounded to float32 where the run's state was complex64.

    Each replayed index ``i`` is also judged (:meth:`observe`) under the
    reference's own distribution ``p`` of that homodyne, by two randomized
    probability integral transforms, with v uniform from ``rng``: of the
    index, F(i - 1) + v p(i), and of its probability, P(p(J) < p(i)) +
    v P(p(J) = p(i)) for J drawn from ``p``. Each is uniform on [0, 1)
    where the run drew from that distribution: the first moves where
    outcomes lie to one side, the second where they fall off the peaks
    (one (B, 2) row per homodyne in :attr:`pits`)."""

    def __init__(self, indices, sketches, rng: np.random.Generator | None = None):
        self._indices = iter(indices)
        self._sketches = iter(sketches)
        self._rng = np.random.default_rng(0) if rng is None else rng
        self.pits: list[np.ndarray] = []

    def index(self, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(next(self._indices), np.int64), device=device)

    def observe(self, dist: torch.Tensor, idx: torch.Tensor) -> None:
        """File the transforms of the drawn ``idx`` (B,) under ``dist`` (B, d)."""
        p = dist.to(torch.float64)
        total = torch.sum(p, -1)
        at = torch.take_along_dim(p, idx[:, None], 1)
        below = torch.sum(torch.where(torch.arange(p.shape[1], device=p.device) < idx[:, None],
                                      p, 0.0), -1)
        less = torch.sum(torch.where(p < at, p, 0.0), -1)
        tied = torch.sum(torch.where(p == at, p, 0.0), -1)
        v = torch.as_tensor(self._rng.random((2, idx.shape[0])), device=p.device)
        u = torch.stack([below + v[0] * at[:, 0], less + v[1] * tied], -1) / total[:, None]
        self.pits.append(u.cpu().numpy())

    def sketch(self) -> torch.Tensor:
        state, n, l, f32 = next(self._sketches)
        g = torch.Generator()
        g.set_state(state)
        o = torch.randn((n, l), generator=g, dtype=torch.float64)
        return o.to(torch.float32).to(torch.float64) if f32 else o

    def finished(self) -> bool:
        return (next(self._indices, None) is None) and (next(self._sketches, None) is None)


def _col_rank(t: torch.Tensor) -> int:
    norms = torch.sum(t.real**2 + t.imag**2, (1, 2))
    idx = torch.arange(1, t.shape[-1] + 1, device=t.device)
    return max(1, int(torch.amax(torch.where(norms > 0, idx, 0))))


def _trim_bucket(n: int) -> int:
    if n <= 16:
        return 1 << (max(1, n) - 1).bit_length()
    return ((n + 15) // 16) * 16


def _syndrome(ta, tb, ma, mb) -> np.ndarray:
    ta, tb, ma, mb = (np.asarray(x, np.float64) for x in (ta, tb, ma, mb))
    mu = 1j * (ma * np.exp(1j * tb) + mb * np.exp(1j * ta)) / np.sin(ta - tb)
    vec = np.stack([mu.real, mu.imag], axis=-1) * 2**0.5
    return np.round(vec / SQPI).astype(np.int32) % 2


def _two_mode_syndromes(kind: str, ms) -> np.ndarray:
    ta, tc, tb, td = _TWO_MODE_ANGLES[kind]
    ma, mb, mc, md = (np.asarray(x, np.float64) for x in ms)
    mu_ab = 1j * (ma * np.exp(1j * tb) + mb * np.exp(1j * ta)) / np.sin(ta - tb)
    mu_cd = 1j * (mc * np.exp(1j * td) + md * np.exp(1j * tc)) / np.sin(tc - td)
    out = []
    for mu in (mu_cd + mu_ab, mu_cd - mu_ab):
        vec = np.stack([mu.real, mu.imag], axis=-1)
        out.append(np.round(vec / SQPI).astype(np.int32) % 2)
    return np.stack(out, axis=1)


class _Replay:
    """One batch through the production path, with host-tracked ranks."""

    def __init__(self, qs, epsilon, max_bond_dim, rel_err, tape, device, dtype):
        self.qs = np.asarray(qs, np.float64)
        self.q = torch.as_tensor(self.qs, device=device)
        self.mbd, self.rel_err, self.tape = int(max_bond_dim), float(rel_err), tape
        self.dtype = dtype
        self.basis = (_gkp(self.q, float(epsilon), 0), _gkp(self.q, float(epsilon), 1))
        self.ranks: list[int] = []

    def bell(self, phase) -> torch.Tensor:
        zero, one = self.basis
        c1 = torch.as_tensor(np.exp(1j * np.asarray(phase, np.float64)), device=one.device)
        bell = torch.stack([zero.expand(c1.shape[0], -1), c1[:, None] * one], -1)
        return (2 ** (-1 / 4) * bell).to(self.dtype)

    def initial(self, coeffs, batch: int):
        zero, one = self.basis
        c = np.asarray(np.asarray(coeffs, np.float32), np.float64)
        dq = float(self.qs[1] - self.qs[0])
        out = []
        for i in range(c.shape[0]):
            psi = zero * complex(c[i, 0, 0], c[i, 0, 1]) + one * complex(c[i, 1, 0], c[i, 1, 1])
            psi = psi / torch.sqrt(torch.sum(psi.real**2 + psi.imag**2) * dq)
            out.append(psi.to(self.dtype).reshape(1, 1, -1, 1).repeat(batch, 1, 1, 1))
        self.ranks = [1] * (c.shape[0] - 1)
        self.cut_gap = np.ones(batch)
        return out

    # -- trims
    def trim(self, tensors):
        if len(tensors) < 2:
            return tensors
        if len(self.ranks) != len(tensors) - 1:
            raise RuntimeError("rank tracker out of step with the chain")
        caps = [int(t.shape[-1]) for t in tensors[:-1]]
        new = [min(c, _trim_bucket(max(1, int(r)))) for r, c in zip(self.ranks, caps)]
        if new == caps:
            return tensors
        out = []
        for i, t in enumerate(tensors):
            l = new[i - 1] if i > 0 else t.shape[1]
            r = new[i] if i < len(tensors) - 1 else t.shape[3]
            out.append(t if (l, r) == (t.shape[1], t.shape[3])
                       else t[:, :l, :, :r].clone(memory_format=torch.contiguous_format))
        return out

    # -- ops
    def insert_bell(self, tensors, idx: int, phase):
        bell = self.bell(phase)
        b_left = bell[:, None]
        b_right = b_left.permute(0, 3, 2, 1)
        if idx == 0:
            out = [b_left, b_right] + list(tensors)
        elif idx == len(tensors):
            out = list(tensors) + [b_left, b_right]
        else:
            t1 = tensors[idx - 1]
            r, d = t1.shape[-1], bell.shape[-2]
            B = bell.shape[0]
            eye = torch.eye(r, dtype=t1.dtype, device=t1.device)
            b2 = b_right[..., 0]
            b1_t = (eye[:, None, :, None] * bell[..., None, :, None, :]).reshape(B, r, d, 2 * r)
            b2_t = (eye[:, None, None, :] * b2[..., None, :, :, None]).reshape(B, 2 * r, d, r)
            out = list(tensors[:idx]) + [b1_t, b2_t] + list(tensors[idx:])
        if idx < len(tensors):
            self.ranks[idx:idx] = [int(out[idx].shape[-1]), int(out[idx + 1].shape[-1])]
        else:
            self.ranks.extend([int(out[idx - 1].shape[-1]), int(out[idx].shape[-1])])
        return out

    def bs(self, tensors, i: int, j: int):
        li, ri = min(i, j), max(i, j)
        t1, t2 = tensors[li], tensors[ri]
        _, a, d, _ = t1.shape
        b = t2.shape[-1]
        if a * d * d * b > STREAM_THRESHOLD:
            raise NotImplementedError(
                f"a streamed split of an ({a}, {d}, {d}, {b}) pair has no reference")
        angle = float(np.pi / 4) * (-1) ** (i > j)
        per = max(1, STREAM_THRESHOLD // (a * d * d * b))
        full_rank = min(a * d, d * b)
        randomized = min(self.mbd, full_rank) * 10 < full_rank
        parts = []
        for z0 in range(0, t1.shape[0], per):
            res = torch.einsum("zaik,zkjb->zaijb", t1[z0:z0 + per], t2[z0:z0 + per])
            res = rotate_fft(self.q, res, angle, 2, 3)
            sketches = ([self.tape.sketch() for _ in range(res.shape[0])]
                        if randomized else None)
            parts.append(split_pair(res, self.mbd, self.rel_err, sketches))
            del res
        out = list(tensors)
        out[li], out[ri], gap = (torch.cat(f) if len(f) > 1 else f[0] for f in zip(*parts))
        self.cut_gap = np.minimum(self.cut_gap, gap.double().cpu().numpy())
        self.ranks[li] = _col_rank(out[li])
        return self.trim(out)

    def single(self, tensors, idx, meas_a2, syn_a1, syn_a2, bell_phase, *, a1):
        out, m1, m2 = fused_single_gadget(tensors, idx, self.qs, self.bell(bell_phase),
                                          a1, np.asarray(meas_a2), self.tape)
        ms = torch.stack([m1, m2], -1).cpu().numpy()
        return out, _syndrome(syn_a1, syn_a2, ms[:, 0], ms[:, 1])

    def fused_pair(self, tensors, m: int, a1, a2):
        L0 = len(tensors)
        a_dim, c_dim = tensors[m].shape[1], tensors[m + 1].shape[-1]
        has_left, has_right = m > 0, m + 2 < L0
        p = m - 1 if (has_left and (a_dim >= c_dim or not has_right)) else m
        out, m1, m2 = fused_pair_measure2(tensors, m, self.qs, a1, a2, self.tape)
        rank = [_col_rank(out[p])] if p < L0 - 3 else []
        nr = self.ranks
        self.ranks = (nr[:m - 1] + rank + nr[m + 2:]) if p == m - 1 else (nr[:m] + rank + nr[m + 3:])
        return self.trim(out), m1.cpu().numpy(), m2.cpu().numpy()

    def two(self, tensors, idx: int, kind: str):
        ta, tc, tb, td = _TWO_MODE_ANGLES[kind]
        zeros = 0.0 * np.ones(tensors[0].shape[0], np.float32)
        tensors = self.insert_bell(tensors, idx, zeros)
        tensors = self.insert_bell(tensors, idx + 4, zeros)
        tensors = self.bs(tensors, idx + 2, idx + 1)
        tensors = self.bs(tensors, idx + 3, idx + 4)
        tensors, m_a, m_c = self.fused_pair(tensors, idx + 2, ta, tc)
        tensors, m_b, m_d = self.fused_pair(tensors, idx + 1, tb, td)
        return tensors, _two_mode_syndromes(kind, (m_a, m_b, m_c, m_d))

    def run(self, layers, tensors, batch: int, N: int):
        frame = np.zeros((batch, N, 2), dtype=np.int32)
        prev_synd = np.zeros((batch, N, 2), dtype=np.int32)
        ones = np.ones(batch, np.float32)
        for layer in layers:
            cur = np.zeros((batch, N, 2), dtype=np.int32)
            for name, ix in layer.gates:
                idx = ix[0]
                if name in ("cP", "cPdg"):
                    cond = prev_synd[:, idx, 0]
                    p_angle = -ARCTAN2 if name == "cPdg" else ARCTAN2
                    a2 = np.where(cond == 1, p_angle, np.pi / 2).astype(np.float32)
                    frame[:, idx, 1] ^= cond & frame[:, idx, 0]
                    tensors, cur[:, idx, :] = self.single(
                        tensors, idx, a2, 0.0 * ones, a2, 0.0 * ones, a1=0.0)
                    continue
                if name in ("T", "Tdg"):
                    base = -1.0 if name == "Tdg" else 1.0
                    sgn = np.where(frame[:, idx, 0] == 1, -base, base).astype(np.float32)
                    tensors, cur[:, idx, :] = self.single(
                        tensors, idx, (np.pi / 2) * ones, 0.0 * ones,
                        sgn * np.pi / 2, sgn * np.pi / 8, a1=0.0)
                    continue
                if name == "H":
                    frame[:, idx, :] = frame[:, idx, ::-1]
                elif name in ("P", "Pdg"):
                    frame[:, idx, 1] ^= frame[:, idx, 0]
                elif name == "CZ":
                    i, j = ix
                    zi = frame[:, i, 1] ^ frame[:, j, 0]
                    zj = frame[:, j, 1] ^ frame[:, i, 0]
                    frame[:, i, 1], frame[:, j, 1] = zi, zj
                elif name == "SWAP":
                    i, j = ix
                    frame[:, [i, j], :] = frame[:, [j, i], :]
                if name == "I":
                    tensors, cur[:, idx, :] = self.single(
                        tensors, idx, (np.pi / 2) * ones, 0.0 * ones,
                        (np.pi / 2) * ones, 0.0 * ones, a1=0.0)
                elif name == "H":
                    tensors, cur[:, idx, :] = self.single(
                        tensors, idx, (-np.pi / 4) * ones, (np.pi / 4) * ones,
                        (-np.pi / 4) * ones, 0.0 * ones, a1=np.pi / 4)
                elif name in ("P", "Pdg"):
                    a2 = (-ARCTAN2 if name == "Pdg" else ARCTAN2) * ones
                    tensors, cur[:, idx, :] = self.single(
                        tensors, idx, a2, 0.0 * ones, a2, 0.0 * ones, a1=0.0)
                else:
                    lo = min(ix)
                    tensors, synd = self.two(tensors, lo, name)
                    cur[:, lo:lo + 2, :] = synd
                    tensors = self.trim(tensors)
            frame ^= cur
            frame ^= np.asarray([layer.paulis], dtype=np.int32)
            prev_synd = cur
        return tensors, frame


# -- readout ---------------------------------------------------------------------
def _pauli_operators(qs: np.ndarray) -> np.ndarray:
    """Grid-sampled GKP Pauli measurement operators [I, X, Y, Z] (Shaw et
    al.), (4, d, d) complex128, with dq = (q[-1] - q[0]) / d."""
    d = len(qs)
    dq = (qs[-1] - qs[0]) / d
    q_diff = qs[:, None] - qs[None, :]
    Xm = np.zeros((d, d))
    zdiag = np.zeros(d)
    max_m = int((qs[-1] - qs[0]) / SQPI) + 1
    for n, m in enumerate(range(1, max_m, 2)):
        coeff = (-1) ** (n % 2) * 2 / (m * np.pi)
        Xm += coeff * (np.sinc((q_diff - m * SQPI) / dq) + np.sinc((q_diff + m * SQPI) / dq))
        zdiag += coeff * 2 * np.cos(SQPI * m * qs)
    Ym = 1j * Xm * zdiag[None, :]
    return np.stack([np.identity(d), Xm, Ym, np.diag(zdiag)]).astype(np.complex128)


_LOGICAL_PAULIS = np.stack([
    np.array([[1, 0], [0, 1]], dtype=complex),
    np.array([[0, 1], [1, 0]], dtype=complex),
    np.array([[0, -1j], [1j, 0]], dtype=complex),
    np.array([[1, 0], [0, -1]], dtype=complex),
])


def readout(tensors, frames: np.ndarray, qs) -> torch.Tensor:
    """Syndrome-corrected logical density C rho C^H, (B, 2^N, 2^N), not
    trace-normalised, in the chain's dtype."""
    qs = np.asarray(qs, np.float64)
    dq = (qs[-1] - qs[0]) / len(qs)
    like = tensors[0]
    Pms = torch.as_tensor(_pauli_operators(qs), device=like.device).to(like.dtype)
    N, B = len(tensors), like.shape[0]
    C = like.new_ones((B, 1))
    for m in tensors:
        a, b = m.shape[1], m.shape[3]
        tmp = torch.einsum("zaci,pdc->zpadi", m, Pms)
        E = torch.einsum("zpadi,zbdj->zpabij", tmp, m.conj()).reshape(B, 4, a * a, b * b)
        C = torch.einsum("z...e,zpef->z...pf", C, E)
    C = C.reshape((B,) + (4,) * N) * (dq / 2) ** N
    Ps = torch.as_tensor(_LOGICAL_PAULIS, device=like.device).to(like.dtype)
    rho = C
    for _ in range(N):
        rho = torch.einsum("zp...,pij->z...ij", rho, Ps)
    perm = [0] + list(range(1, 2 * N + 1, 2)) + list(range(2, 2 * N + 1, 2))
    rho = rho.permute(perm).reshape(B, 2**N, 2**N)

    f = torch.as_tensor(np.asarray(frames, np.int32), device=like.device)
    eye = torch.eye(2, dtype=torch.float64, device=like.device)
    X, Z = eye.flip(0), eye.clone()
    Z[1, 1] = -1.0
    corr = eye.new_ones((B, 1, 1))
    for i in range(N):
        m = torch.where(f[:, i, 1, None, None] == 1, Z, eye)
        m = torch.where(f[:, i, 0, None, None] == 1, X @ m, m)
        corr = torch.einsum("zab,zcd->zacbd", corr, m).reshape(
            B, corr.shape[1] * 2, corr.shape[2] * 2)
    corr = corr.to(rho.dtype)
    return corr @ rho @ corr.mH


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def replay_batch(gates, N: int, coeffs, batch: int, tape: Tape, *, qs, epsilon: float,
                 max_bond_dim: int, rel_err: float, device,
                 dtype=torch.complex128, tf32: bool = False):
    """The batch's (rho (B, 2^N, 2^N) complex numpy, frames (B, N, 2),
    cut gaps (B,)) from the circuit's DV gates and the timed run's draws:
    a trajectory's cut gap is the smallest
    :func:`.linalg.cut_gap` of its splits; ``tape.pits`` judges the draws. ``dtype`` and ``tf32`` set the
    precision: complex128 for the reference, complex64 with TF32 products
    for the control."""
    layers = transpile(gates, N)
    with _matmul_precision(tf32), torch.no_grad():
        run = _Replay(qs, epsilon, max_bond_dim, rel_err, tape, torch.device(device), dtype)
        tensors = run.initial(coeffs, batch)
        tensors, frames = run.run(layers, tensors, batch, N)
        rho = readout(tensors, frames, qs)
        rho = rho.to(torch.complex128).cpu().numpy()
    if not tape.finished():
        raise RuntimeError("the replay left draws of the timed run unused")
    return rho, frames, run.cut_gap
