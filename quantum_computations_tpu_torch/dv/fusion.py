"""Gate fusion into multi-qubit window unitaries (counterpart of
``quantum_computations_tpu/dv/fusion.py``).

A single-qubit gate pass over a 2^N state vector moves every amplitude for
8 real FLOPs. Consecutive gates whose combined support fits a window of
k <= 7 qubits are composed on the host in numpy into one (2^k, 2^k)
unitary and applied in one pass. The host-side planners below are the JAX
package's, unchanged; :func:`apply_window` (complex state) and
:func:`apply_window_split` (split-real planes) are plain PyTorch.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from ..config import full_fp32_matmul

__all__ = ["fuse_windows", "merge_adjacent_windows", "apply_window",
           "apply_window_split", "MAX_WINDOW_BITS"]

MAX_WINDOW_BITS = 7  # 2^7 = 128: the widest slab window


def _np_expand(gate: np.ndarray, k: int, positions: list[int]) -> np.ndarray:
    """Expand a gate on ``positions`` (within a k-qubit window) to 2^k x 2^k.

    Windows are tiny (k <= 7), so the dense kron is microseconds.
    """
    g = int(np.log2(gate.shape[0]))
    missing = [i for i in range(k) if i not in positions]
    full = np.kron(gate, np.eye(1 << len(missing), dtype=gate.dtype))
    # tensor factors are currently ordered positions + missing; permute to 0..k-1
    order = list(positions) + missing
    inv = np.argsort(order)
    t = full.reshape((2,) * (2 * k))
    perm = list(inv) + [k + int(p) for p in inv]
    return t.transpose(perm).reshape(1 << k, 1 << k)


def fuse_windows(gates, max_bits: int = MAX_WINDOW_BITS,
                 dtype=np.complex128):
    """Greedily fuse a gate list into window unitaries.

    ``gates``: iterable of ``(matrix, targets)`` with host-numpy matrices of
    shape (2^j, 2^j), j <= max_bits, and integer qubit targets (any
    convention — targets are opaque labels here). Returns a list of
    ``(U, targets)`` with ``U`` a (2^k, 2^k) numpy array and ``targets`` the
    window's qubits sorted ascending; row/col index bit i of ``U`` (MSB
    first) corresponds to ``targets[i]``.

    Fusion is order-preserving up to commutation: within a maximal run of
    single-qubit gates, gates are regrouped so same-qubit gates sit adjacent
    (1q gates on distinct qubits always commute, so this is exact) — a run
    of m 1q gates over q distinct qubits then packs into ceil(q/max_bits)
    windows. Across multi-qubit gates no reordering happens: a gate joins
    the current window iff the union of supports stays within ``max_bits``;
    otherwise the window is flushed.
    """
    windows = []
    cur: list[tuple[np.ndarray, tuple[int, ...]]] = []
    support: set[int] = set()

    def flush():
        if not cur:
            return
        w = sorted(support)
        k = len(w)
        u = np.eye(1 << k, dtype=dtype)
        for mat, tgts in cur:
            pos = [w.index(t) for t in tgts]
            u = _np_expand(np.asarray(mat, dtype=dtype), k, pos) @ u
        windows.append((u, tuple(w)))
        cur.clear()
        support.clear()

    for g in _reorder_1q_runs(gates):
        mat, targets = g
        tset = set(targets)
        if support and len(support | tset) > max_bits:
            flush()
        cur.append((mat, targets))
        support |= tset
    flush()
    return windows


def merge_adjacent_windows(windows, max_bits: int = MAX_WINDOW_BITS,
                           dtype=np.complex128):
    """Merge consecutive windows whose union support fits ``max_bits``.

    :func:`fuse_windows` already packs consecutive *gates*; this pass packs
    consecutive *windows* — useful after a scheduler has reordered commuting
    windows so same-support windows became adjacent. Exact: adjacent windows
    compose as operators regardless of support overlap.
    """
    out: list[tuple[np.ndarray, tuple[int, ...]]] = []
    for u, t in windows:
        if out:
            pu, pt = out[-1]
            union = sorted(set(pt) | set(t))
            if len(union) <= max_bits:
                k = len(union)
                a = _np_expand(np.asarray(pu, dtype=dtype), k,
                               [union.index(q) for q in pt])
                b = _np_expand(np.asarray(u, dtype=dtype), k,
                               [union.index(q) for q in t])
                out[-1] = (b @ a, tuple(union))
                continue
        out.append((np.asarray(u, dtype=dtype), tuple(t)))
    return out


def _reorder_1q_runs(gates):
    """Normalise a gate list: maximal runs of 1q gates are regrouped so
    same-qubit gates are adjacent, in first-appearance qubit order (exact —
    1q gates on distinct qubits commute). Yields (matrix, targets) tuples.
    """
    run: dict[int, list] = {}

    def drain():
        for q, mats in run.items():
            for m in mats:
                yield m, (q,)
        run.clear()

    for g in gates:
        mat, targets = g if isinstance(g, tuple) else (g.matrix, tuple(g.indices))
        mat = np.asarray(mat)
        targets = tuple(int(t) for t in targets)
        if len(targets) == 1:
            run.setdefault(targets[0], []).append(mat)
        else:
            yield from drain()
            yield mat, targets
    yield from drain()


def _grouped_view(N: int, targets: tuple[int, ...]):
    """Interleaved-segment shape for qubits ``targets`` (sorted, big-endian
    axis order): (seg0, 2, seg1, 2, ..., 2, segk) with segments collapsed.

    Returns (shape, target_axes) where target_axes[i] is the axis of
    targets[i] in the reshaped view. Rank <= 2k+1 (15 for k=7) at any N,
    unlike the rank-N (2,)*N view.
    """
    shape: list[int] = []
    target_axes: list[int] = []
    prev = 0
    for t in targets:
        seg = 1 << (t - prev)
        if seg > 1:
            shape.append(seg)
        target_axes.append(len(shape))
        shape.append(2)
        prev = t + 1
    tail = 1 << (N - prev)
    if tail > 1:
        shape.append(tail)
    return tuple(shape), tuple(target_axes)


def _window_subscripts(rank: int, target_axes: tuple[int, ...]):
    """einsum string for contracting a (2,)*2k operator into the view."""
    k = len(target_axes)
    letters = string.ascii_letters
    in_sub = [letters[i] for i in range(rank)]
    out_sub = list(in_sub)
    op_out = [letters[rank + i] for i in range(k)]
    op_in = [in_sub[ax] for ax in target_axes]
    for i, ax in enumerate(target_axes):
        out_sub[ax] = op_out[i]
    return (f"{''.join(op_out)}{''.join(op_in)},"
            f"{''.join(in_sub)}->{''.join(out_sub)}")


def apply_window(state: torch.Tensor, u, targets: tuple[int, ...],
                 num_qubits: int) -> torch.Tensor:
    """Apply a fused window unitary to a complex state vector, out of place.

    ``u``: (2^k, 2^k), rows and columns over ``targets``; ``targets``:
    sorted big-endian qubit indices. One grouped einsum (rank <= 2k+1 at
    any N), in full FP32 for a complex64 state.
    """
    k = len(targets)
    shape, taxes = _grouped_view(num_qubits, tuple(targets))
    op = torch.as_tensor(u).to(device=state.device, dtype=state.dtype)
    with full_fp32_matmul():
        return torch.einsum(_window_subscripts(len(shape), taxes),
                            op.reshape((2,) * (2 * k)),
                            state.reshape(shape)).reshape(-1)


def apply_window_split(re: torch.Tensor, im: torch.Tensor,
                       u_re: torch.Tensor, u_im: torch.Tensor,
                       targets: tuple[int, ...], num_qubits: int):
    """Apply a window unitary to split-real (re, im) float planes.

    ``u_re``/``u_im``: real and imaginary parts of the (2^k, 2^k) window,
    NOT transposed; ``targets``: sorted big-endian qubit indices. Out of
    place, in full FP32 (no TF32).

    Fast path: when the targets are exactly the trailing (minor-slab)
    qubits, the contraction is a plain ``(R, 2^k) @ (2^k, 2^k)`` matmul.
    Scattered targets use the grouped einsum.
    """
    N = num_qubits
    k = len(targets)
    u_re = u_re.to(re.dtype)
    u_im = u_im.to(re.dtype)
    with full_fp32_matmul():
        if tuple(targets) == tuple(range(N - k, N)):
            d = 1 << k
            xr = re.reshape(-1, d)
            xi = im.reshape(-1, d)
            urt, uit = u_re.T, u_im.T
            out_r = xr @ urt - xi @ uit
            out_i = xi @ urt + xr @ uit
            return out_r.reshape(-1), out_i.reshape(-1)
        shape, taxes = _grouped_view(N, tuple(targets))
        sub = _window_subscripts(len(shape), taxes)
        xr = re.reshape(shape)
        xi = im.reshape(shape)
        ur = u_re.reshape((2,) * (2 * k))
        ui = u_im.reshape((2,) * (2 * k))
        rr = torch.einsum(sub, ur, xr)
        ii = torch.einsum(sub, ui, xi)
        ri = torch.einsum(sub, ur, xi)
        ir = torch.einsum(sub, ui, xr)
    return (rr - ii).reshape(-1), (ri + ir).reshape(-1)
