"""Plain state-vector reference: quantum-volume circuits, and a gate-by-gate
simulator in complex128.

:func:`quantum_volume` draws the model circuits of Cross et al.,
"Validating quantum computers using randomized model circuits"
(arXiv:1811.12926): width m, ``depth`` layers, each a uniformly random
permutation of the qubits and a Haar-random SU(4) on each of its
floor(m/2) pairs. A gate is ``(4x4 complex128 matrix, (q_a, q_b))``; the
most significant bit of the matrix's row and column index is qubit
``q_a``, as in the port's ``(matrix, targets)`` gate tuples.

:func:`simulate` applies a gate list to |0...0>, one gate at a time, to a
complex vector in logical order (qubit l is bit n - 1 - l of the index). No
fusion, no layout, no kernels: each gate copies the 2^k input slices of the
(2^a, 2, 2^b, 2, 2^c) view of the state into the rows of a second vector,
multiplies those rows by the gate's matrix in one product written over the
first, and copies the 2^k output rows back into the second as the slices
of the same view, so the state is in logical order after every gate and
two vectors of 2^n are live (32 GiB at n = 30 in complex128).

Departures from arXiv:1811.12926:

- SU(4) is drawn by QR of a complex Ginibre matrix, with the phases of R's
  diagonal moved into Q and Q divided by a fourth root of its determinant,
  not by Qiskit's own routine: the circuits follow the protocol's law, not
  ``qiskit.circuit.library.QuantumVolume``'s draws for a seed.
- Each layer draws its permutation first and then its pairs' unitaries in
  order, all from one numpy generator.

This module imports torch and numpy only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_TF32_MASK = -(1 << 13)  # float32 bits with the low 13 mantissa bits cleared
_ROUND_CHUNK = 1 << 24   # float64 values rounded per step (128 MiB)


def haar_su4(rng: np.random.Generator) -> np.ndarray:
    """A Haar-random 4x4 special unitary (complex128)."""
    z = (rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))) / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    return q / np.linalg.det(q) ** 0.25


def quantum_volume(num_qubits: int, depth: int, rng: np.random.Generator) -> list:
    """The gates of one quantum-volume model circuit, in gate order:
    ``[(4x4 complex128 matrix, (q_a, q_b)), ...]``, floor(m/2) a layer."""
    gates = []
    for _ in range(depth):
        perm = rng.permutation(num_qubits)
        for k in range(num_qubits // 2):
            gates.append((haar_su4(rng), (int(perm[2 * k]), int(perm[2 * k + 1]))))
    return gates


@contextlib.contextmanager
def _full_precision():
    """Float32 products in full precision on the card (no TF32) while the
    block runs, as a reference must; the settings are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _tf32(x: np.ndarray) -> np.ndarray:
    """A complex matrix with each part rounded to float32 and its low 13
    mantissa bits cleared (TF32), back in complex128."""
    def part(a):
        bits = np.asarray(a, np.float32).view(np.int32) & _TF32_MASK
        return bits.view(np.float32).astype(np.float64)
    return part(x.real) + 1j * part(x.imag)


def _tf32_(psi: torch.Tensor) -> None:
    """:func:`_tf32` of a complex state in place, a chunk at a time."""
    flat = torch.view_as_real(psi).reshape(-1)
    for s in range(0, flat.numel(), _ROUND_CHUNK):
        part = flat[s:s + _ROUND_CHUNK]
        bits = part.to(torch.float32).view(torch.int32) & _TF32_MASK
        part.copy_(bits.view(torch.float32))


def _apply(psi: torch.Tensor, out: torch.Tensor, u: np.ndarray, targets, n: int) -> None:
    """``out`` = the k-qubit gate ``u`` on ``targets`` (gate order) of ``psi``,
    through the 2^k slices of the (2^a, 2, 2^b, ..., 2^c) view; ``psi`` is
    overwritten."""
    k = len(targets)
    if len(set(targets)) != k or not all(0 <= t < n for t in targets):
        raise ValueError(f"bad targets {targets} for {n} qubits")
    order = sorted(range(k), key=lambda i: targets[i])
    u = np.asarray(u, np.complex128).reshape((2,) * (2 * k))
    u = u.transpose(order + [k + i for i in order]).reshape(1 << k, 1 << k)
    shape, prev = [], -1
    for p in sorted(targets):
        shape += [1 << (p - prev - 1), 2]
        prev = p
    shape.append(1 << (n - 1 - prev))
    rest = shape[0::2]  # a slice's shape: the view without the target axes

    def part(index: int):
        bits = [(index >> (k - 1 - j)) & 1 for j in range(k)]
        return tuple(b for bit in bits for b in (slice(None), bit)) + (slice(None),)

    x, y = psi.view(shape), out.view(shape)
    rows, product = out.view(1 << k, -1), psi.view(1 << k, -1)
    for j in range(1 << k):
        rows[j].view(rest).copy_(x[part(j)])
    torch.matmul(torch.from_numpy(u).to(psi.device, psi.dtype), rows, out=product)
    for i in range(1 << k):
        y[part(i)].copy_(product[i].view(rest))


def simulate(gates, n: int, device="cpu", dtype=torch.complex128, *,
             tf32_inputs: bool = False) -> torch.Tensor:
    """The state of ``gates`` (``(matrix, targets)``, targets in gate order)
    from |0...0> on ``n`` qubits, as a ``dtype`` vector on ``device`` in
    logical order. With ``tf32_inputs`` the inputs of every gate product,
    the state and the matrix, are first rounded to TF32 (the precision
    control: how a product with TF32 inputs reads)."""
    with _full_precision():
        psi = torch.zeros(1 << n, dtype=dtype, device=device)
        psi[0] = 1.0
        out = torch.empty_like(psi)
        for u, targets in gates:
            u = np.asarray(u, np.complex128)
            if tf32_inputs:
                _tf32_(psi)
                u = _tf32(u)
            _apply(psi, out, u, tuple(int(t) for t in targets), n)
            psi, out = out, psi
        del out
    return psi
