"""Large-N split-real state-vector engine (counterpart of
``quantum_computations_tpu/dv/fast_sv.py``), in its slab, window and chain
modes.

The state is two float32 planes (re, im) of length 2^N on one device. At
N = 30 each plane is 4 GiB, and the window update runs in place.

Gate scheduling (``fusion_mode``):

- ``"slab"`` (default) — gates fuse into <=7-qubit *window* unitaries
  (:mod:`.fusion`) and apply on the minor 2^S-wide slab as one
  ``(R, 2^S) @ (2^S, 2^S)`` split-real product, through the Hopper kernel
  :func:`..ops.slab_kernels.slab_matmul` on CUDA (in place) and its plain
  version on the CPU. The logical->physical axis layout is lazy: a window
  whose qubits live outside the slab pays grouped transpose passes to move
  them in, and they stay. ``re``/``im`` are in PHYSICAL axis order when the
  layout is permuted; use ``probs()``/``sample()``/``norm_sq()``, which
  read through the layout.
- ``"window"`` — the same fused windows applied in logical order by the
  grouped einsum of :func:`.fusion.apply_window_split` (plain PyTorch).
- ``"chain"`` — the per-gate kernels of :mod:`..ops.gate_kernels`, planned
  as the JAX engine plans them (:meth:`FastStatevector._plan`): runs of
  fusable single-qubit gates form one ``apply_1q_chain`` pass, adjacent
  pairs with inner >= 128 one ``apply_2q_adjacent`` pass, and every other
  gate a general step (``apply_1q`` for one qubit, else the plain grouped
  einsum of :func:`_apply_xla_general`). The layout stays the identity.

Each layout pass is one or more ``reshape -> permute -> contiguous``
copies, run on one plane and then the other, each copy replacing the plane
it read, so at most three planes are live at a time.

Spans (:func:`..utils.profiling.span`): ``op:sv_plan`` (fusion, window
scheduling and, in :meth:`FastStatevector.run_compiled`, the recorded plan
with its window uploads), ``op:sv_layout`` (each layout pass),
``op:sv_window`` (each ``slab_matmul`` launch) and ``op:sv_readout``
(:meth:`~FastStatevector.amplitudes`, :meth:`~FastStatevector.sample`,
:meth:`~FastStatevector.norm_sq`). Counters on the engine:
``layout_passes``, ``plane_copies`` and ``layout_bytes`` (the copies that
layout passes ran, and the bytes they read and wrote) and ``slab_windows``
(``slab_matmul`` launches).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from . import fusion
from ..config import REAL_DTYPE, resolve_device
from ..ops import gate_kernels, slab_kernels
from ..utils.profiling import span

__all__ = ["FastStatevector", "order_windows", "plan_slab_residency"]


def _move_axes_to_end_plan(N: int, axes: tuple[int, ...]):
    """(view_shape, permutation) sending physical axes ``axes`` (sorted)
    to the trailing positions, keeping the order of the others, on the
    interleaved-segment grouped view (rank <= 2k+1)."""
    shape, taxes = fusion._grouped_view(N, axes)
    others = [i for i in range(len(shape)) if i not in taxes]
    return tuple(shape), tuple(others) + tuple(taxes)


def _permute_copy(x: torch.Tensor, shape: tuple, perm: tuple) -> torch.Tensor:
    """One layout copy of a flat plane: view as ``shape``, permute, flatten."""
    return x.reshape(shape).permute(perm).contiguous().reshape(-1)


def _remap_basis(x, axis_of, to_physical: bool):
    """Basis indices ``x`` (a numpy array or a tensor of integers) moved
    between the LOGICAL order (qubit l is bit N - 1 - l) and the physical
    order of the layout ``axis_of`` (qubit l is bit N - 1 - axis_of[l]),
    bit by bit, on the device or host where ``x`` lives."""
    N = len(axis_of)
    out = x & 0
    for l, p in enumerate(axis_of):
        src, dst = (N - 1 - l, N - 1 - p) if to_physical else (N - 1 - p, N - 1 - l)
        out |= ((x >> src) & 1) << dst
    return out


def _block_swap_plan(num_qubits: int, slab_bits: int):
    """Swap the slab (last S axes) with block B (the S axes above it)."""
    S = slab_bits
    A = 1 << (num_qubits - 2 * S)
    d = 1 << S
    return [((A, d, d), (0, 2, 1))]


def _move_axes_raw(x: torch.Tensor, axes: tuple, num_qubits: int):
    """Direct grouped move of physical ``axes`` to the end (one pass)."""
    return _permute_copy(x, *_move_axes_to_end_plan(num_qubits, axes))


def _block_swap_raw(x: torch.Tensor, num_qubits: int, slab_bits: int):
    return _permute_copy(x, *_block_swap_plan(num_qubits, slab_bits)[0])


# Above this plane size (bytes of one f32 plane) an upper move runs as
# per-run middle swaps (the JAX engine's choice, kept so both engines take
# the same passes). QCT_SV_MOVE_DECOMP=1/0 forces the choice.
_MOVE_DECOMP_BYTES = 2 << 30


def _move_decomposition(axes: tuple, num_qubits: int, slab_bits: int,
                        to_front: bool) -> list[tuple[int, int, int, int]]:
    """Decompose an upper move into single middle-swap passes.

    Returns [(p, x, y, q), ...]: each pass is
    ``v.reshape(p, x, y, q).swapaxes(1, 2)`` — a 4-axis transpose whose
    minor dim is untouched (>= the 2^S slab). One pass per contiguous run
    of target axes:

    - to_back (``to_front=False``): runs processed right-to-left, each run G
      swaps past everything right of it (B) and merges into the minor block
      Q (initially the slab); final upper order = others + targets(sorted),
      exactly :func:`_upper_move_raw`'s permutation.
    - to_front: runs processed left-to-right, each run G swaps past the
      non-target block A to its left and merges into the leading block P;
      final order = targets(sorted) + others.
    """
    Nu = num_qubits - slab_bits
    shape, taxes = fusion._grouped_view(Nu, axes)
    sizes = list(shape)
    is_tgt = [i in taxes for i in range(len(sizes))]
    # contiguous runs of target axes in the grouped view
    runs: list[tuple[int, int]] = []  # [start, end) index ranges
    i = 0
    while i < len(sizes):
        if is_tgt[i]:
            j = i
            while j < len(sizes) and is_tgt[j]:
                j += 1
            runs.append((i, j))
            i = j
        else:
            i += 1
    passes: list[tuple[int, int, int, int]] = []
    if not to_front:
        Q = 1 << slab_bits
        rem = list(sizes)
        rem_tgt = list(is_tgt)
        for (i0, j0) in reversed(runs):
            G = math.prod(rem[i0:j0])
            B = math.prod(rem[j0:])
            P = math.prod(rem[:i0])
            if B > 1:
                passes.append((P, G, B, Q))
            Q *= G
            del rem[i0:j0], rem_tgt[i0:j0]
    else:
        # left-to-right: each run G hops over the (contiguous, growing)
        # non-target block A to land right after the already-moved runs F
        F = 1  # product of runs already moved to the front
        A = 1  # product of non-target sizes swept past so far
        idx = 0
        for (i0, j0) in runs:
            A *= math.prod(sizes[idx:i0])
            G = math.prod(sizes[i0:j0])
            Q = math.prod(sizes[j0:]) * (1 << slab_bits)
            if A > 1:
                passes.append((F, A, G, Q))
            F *= G
            idx = j0
    return passes


def _upper_move_plan(axes: tuple, num_qubits: int, slab_bits: int,
                     to_front: bool):
    """Copies relocating UPPER physical axes ``axes`` to the end (or front)
    of the upper region, the slab untouched (a trailing 2^S-wide axis)."""
    decomp = os.environ.get("QCT_SV_MOVE_DECOMP", "auto")
    if decomp == "1" or (decomp != "0"
                         and ((4 << num_qubits) >= _MOVE_DECOMP_BYTES)):
        return [((p, xs, ys, q), (0, 2, 1, 3)) for (p, xs, ys, q)
                in _move_decomposition(axes, num_qubits, slab_bits, to_front)]
    Nu = num_qubits - slab_bits
    shape, taxes = fusion._grouped_view(Nu, axes)
    shape = shape + (1 << slab_bits,)
    slab_ax = len(shape) - 1
    others = tuple(i for i in range(slab_ax) if i not in taxes)
    if to_front:
        perm = tuple(taxes) + others + (slab_ax,)
    else:
        perm = others + tuple(taxes) + (slab_ax,)
    return [(shape, perm)]


def _upper_move_raw(x: torch.Tensor, axes: tuple, num_qubits: int,
                    slab_bits: int, to_front: bool):
    for shape, perm in _upper_move_plan(axes, num_qubits, slab_bits, to_front):
        x = _permute_copy(x, shape, perm)
    return x


def _layout_copies(op: tuple, N: int, S: int):
    """The permute copies of one ``plan_slab_residency`` op, per plane."""
    if op[0] == "swap":
        return _block_swap_plan(N, S)
    if op[0] == "move":
        return _upper_move_plan(op[1], N, S, op[2])
    return [_move_axes_to_end_plan(N, op[1])]  # scatter


def _swap_newpos(N: int, S: int):
    """old→new physical-axis map of the slab <-> block-B swap."""
    slab_start = N - S

    def f(p):
        if p >= slab_start:
            return p - S
        if p >= slab_start - S:
            return p + S
        return p

    return f


def _move_newpos(N: int, S: int, srcs: tuple[int, ...], to_front: bool):
    """old→new physical-axis map of an upper-region move (slab untouched)."""
    Nu = N - S
    src_set = set(srcs)
    others = [p for p in range(Nu) if p not in src_set]
    newpos = {}
    if to_front:
        for r, p in enumerate(srcs):
            newpos[p] = r
        for r, p in enumerate(others):
            newpos[p] = len(srcs) + r
    else:
        for r, p in enumerate(others):
            newpos[p] = r
        for r, p in enumerate(srcs):
            newpos[p] = len(others) + r
    return lambda p: newpos.get(p, p)


def _scatter_newpos(N: int, move: tuple[int, ...]):
    """old→new physical-axis map of the direct grouped move-to-end."""
    moved = set(move)
    untouched = [p for p in range(N) if p not in moved]
    newpos = {p: r for r, p in enumerate(untouched)}
    for r, p in enumerate(move):
        newpos[p] = len(untouched) + r
    return lambda p: newpos[p]


def plan_slab_residency(N: int, S: int, scatter_move_max: int,
                        phys: list[int], emit) -> list[int]:
    """Emit the minor-safe pass sequence bringing physical axes ``phys``
    into the minor slab (the last S axes of an N-axis register).

    ``emit(op, newpos)`` executes or records ONE pass and must apply
    ``newpos`` (old → new physical axis) to the caller's own layout
    bookkeeping. Ops are ``("swap",)``, ``("move", srcs, to_front)`` and
    ``("scatter", srcs)``. Returns the targets' final physical positions
    (all >= N - S).

    Large N uses only passes whose transpose output keeps a 2^S-wide minor
    axis (the JAX engine's scheme, kept so both engines take the same
    passes):

    1. targets in BOTH the slab and the upper region: move the upper
       targets to the front of the upper region (1 pass — front positions
       are outside block B since N >= 3S + 1 there);
    2. any slab-resident target: slab <-> B swap evicts them to B;
    3. move all targets to the end of the upper region;
    4. slab <-> B swap brings them in.
    """
    slab_start = N - S
    phys = list(phys)
    if all(p >= slab_start for p in phys):
        return phys
    if N < 3 * S + 1 or N <= scatter_move_max:
        srcs = tuple(sorted(phys))
        f = _scatter_newpos(N, srcs)
        emit(("scatter", srcs), f)
        return [f(p) for p in phys]
    in_slab = [p for p in phys if p >= slab_start]
    upper = tuple(sorted(p for p in phys if p < slab_start))
    if in_slab and upper:
        f = _move_newpos(N, S, upper, True)
        emit(("move", upper, True), f)
        phys = [f(p) for p in phys]
    if in_slab:
        f = _swap_newpos(N, S)
        emit(("swap",), f)
        phys = [f(p) for p in phys]
    assert all(p < slab_start for p in phys)
    srcs = tuple(sorted(phys))
    f = _move_newpos(N, S, srcs, False)
    emit(("move", srcs, False), f)
    phys = [f(p) for p in phys]
    f = _swap_newpos(N, S)
    emit(("swap",), f)
    return [f(p) for p in phys]


def _residency_cost(N: int, S: int, scatter_move_max: int,
                    layout: list[int], tgts: tuple[int, ...]):
    """(pass_count, layout_after) of bringing logical ``tgts`` slab-resident
    from ``layout`` — a pure simulation of :func:`plan_slab_residency` on a
    shadow table (no planes touched)."""
    lay = list(layout)
    passes = 0

    def emit(op, newpos):
        nonlocal passes
        passes += 1
        lay[:] = [newpos(p) for p in lay]

    plan_slab_residency(N, S, scatter_move_max, [lay[t] for t in tgts], emit)
    return passes, lay


# Window count above which greedy scheduling falls back to circuit order
# (the O(n^2) host-side planning would dominate for very long unfused
# chains; ~500 windows keeps planning well under a second).
_PLAN_MAX_WINDOWS = 512


def order_windows_by_cost(windows, state, cost_fn):
    """Commutation-exact greedy scheduling of fused windows.

    Windows on disjoint qubit supports commute exactly, so any topological
    order of the overlap-dependency DAG is equivalent. Lazy layouts make the
    order *performance-relevant*: a window whose targets are already
    resident costs nothing, one that isn't pays layout passes. Greedy list
    scheduling: among ready windows pick the one whose simulated residency
    plan from the current shadow ``state`` has the lowest ``cost_fn(state,
    targets) -> (cost, state_after)``, tie-broken by original circuit
    position; then advance the shadow state.

    Scheduling is O(n^2) in the window count (DAG edges + one residency
    simulation per (step, ready window)); above ``_PLAN_MAX_WINDOWS`` the
    planner falls back to circuit order.
    """
    n = len(windows)
    if n <= 1 or n > _PLAN_MAX_WINDOWS:
        return list(windows)
    supports = [set(t) for _, t in windows]
    preds_left = [0] * n
    succs: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i):
            if supports[i] & supports[j]:
                preds_left[i] += 1
                succs[j].append(i)
    ready = [i for i in range(n) if preds_left[i] == 0]
    order: list[int] = []
    while ready:
        ready.sort()
        best, best_cost, best_state = None, None, None
        for i in ready:
            cost, state_after = cost_fn(state, windows[i][1])
            if best_cost is None or cost < best_cost:
                best, best_cost, best_state = i, cost, state_after
                if cost == 0:
                    break  # can't beat a resident window
        ready.remove(best)
        order.append(best)
        state = best_state
        for s in succs[best]:
            preds_left[s] -= 1
            if preds_left[s] == 0:
                ready.append(s)
    return [windows[i] for i in order]


def order_windows(windows, N: int, S: int, scatter_move_max: int,
                  layout: list[int]):
    """Single-device slab-engine planner: schedule windows to minimise
    layout passes, then let the caller merge now-adjacent same-support
    windows (:func:`.fusion.merge_adjacent_windows`)."""
    return order_windows_by_cost(
        windows, list(layout),
        lambda lay, tgts: _residency_cost(N, S, scatter_move_max, lay, tgts))


def _apply_xla_general(re: torch.Tensor, im: torch.Tensor, u,
                       targets: tuple[int, ...], num_qubits: int):
    """A k-qubit unitary on big-endian ``targets`` IN GATE ORDER (e.g.
    ``CX(5, 2)``), out of place, plain PyTorch.

    The counterpart of the JAX engine's tensordot step. The operator is
    permuted to sorted target order and applied by the grouped einsum of
    :func:`.fusion.apply_window_split` (rank <= 2k+1 at any N, never the
    rank-N view).
    """
    k = len(targets)
    order = sorted(range(k), key=lambda i: targets[i])
    u = np.asarray(u, np.complex128).reshape((2,) * (2 * k))
    u = u.transpose(order + [k + i for i in order]).reshape(1 << k, 1 << k)
    u = u.astype(np.complex64)

    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(re.device)

    return fusion.apply_window_split(re, im, plane(u.real), plane(u.imag),
                                     tuple(targets[i] for i in order),
                                     num_qubits)


@dataclass
class _Plan:
    """One scheduled device call of chain mode."""

    kind: str                      # "chain" | "2q" | "xla"
    matrices: list = field(default_factory=list)
    bits: list = field(default_factory=list)    # chain: amplitude bits
    targets: tuple = ()                         # 2q/xla: qubit indices


class FastStatevector:
    """Unitary-circuit engine over split-real float32 planes.

    Parameters
    ----------
    num_qubits:
        State size; planes are float32 of shape (2**num_qubits,).
    device:
        ``"cuda"`` (default; raises without a CUDA device) or ``"cpu"``.
        On CUDA every slab window and every chain-mode kernel step goes
        through its Hopper kernel, on the CPU through its plain version.
    fusion_mode:
        ``"slab"`` (default, or ``QCT_SV_FUSION``), ``"window"`` or
        ``"chain"``.
    """

    C_BITS = 11  # chain planner's columns; sample()'s row/column split
    BLOCK_ROWS = 32  # chain planner's block rows (the JAX engine's layout)

    def __init__(self, num_qubits: int, *,
                 device: str | torch.device | None = None,
                 fusion_mode: str | None = None):
        self.N = int(num_qubits)
        if fusion_mode is None:
            fusion_mode = os.environ.get("QCT_SV_FUSION", "slab")
        if fusion_mode not in ("window", "chain", "slab"):
            raise ValueError(f"unknown fusion_mode {fusion_mode!r}")
        self.fusion_mode = fusion_mode
        self.device = resolve_device(device)
        self.c_bits = min(self.C_BITS, self.N - 1)
        self.block_rows = min(self.BLOCK_ROWS, 1 << (self.N - self.c_bits))
        # chain mode: the amplitude bits the planner fuses into one pass
        self._fusable = set(gate_kernels.fusable_bits(self.N, self.c_bits,
                                                      self.block_rows))
        n = 1 << self.N
        self.re = torch.zeros(n, dtype=REAL_DTYPE, device=self.device)
        self.re[0] = 1.0
        self.im = torch.zeros(n, dtype=REAL_DTYPE, device=self.device)
        # slab mode: logical axis -> physical axis (lazy layout; axes move
        # into the minor slab on demand and stay there)
        self.axis_of = list(range(self.N))
        self.slab_bits = min(fusion.MAX_WINDOW_BITS, self.N)
        # N up to this uses the direct grouped move (1 pass); tests lower it
        # (with a small slab_bits) to exercise the minor-safe sequence
        self.scatter_move_max = 21
        self._plan_only = None  # set by run_compiled during planning
        # layout-aware window scheduling (order_windows); exact, default on
        self.plan_windows = os.environ.get("QCT_SV_PLAN", "1") != "0"
        self.layout_passes = 0  # move/swap/scatter passes executed so far
        self.plane_copies = 0   # permute copies those passes ran, both planes
        self.layout_bytes = 0   # bytes the copies read and wrote
        self.slab_windows = 0   # slab_matmul launches

    def reset(self) -> "FastStatevector":
        """Back to |0...0> in the identity layout, in place: the planes the
        engine holds are overwritten, none is allocated. Returns self."""
        self.re.zero_()
        self.re[0] = 1.0
        self.im.zero_()
        self.axis_of = list(range(self.N))
        return self

    # -- carrying state across ---------------------------------------------
    def load_numpy(self, re: np.ndarray, im: np.ndarray, axis_of) -> \
            "FastStatevector":
        """Take planes (in physical order) and their layout table, e.g. from
        the JAX engine's ``re``, ``im`` and ``axis_of``. Returns self.

        Only slab mode keeps a lazy layout; in window and chain mode each
        plane is brought to the identity layout on the host (one numpy
        transpose) before upload."""
        n = 1 << self.N
        re = np.asarray(re, np.float32).reshape(-1)
        im = np.asarray(im, np.float32).reshape(-1)
        if re.size != n or im.size != n:
            raise ValueError(f"planes must hold 2**{self.N} = {n} values, got "
                             f"{re.size} and {im.size}")
        axis_of = [int(a) for a in axis_of]
        if sorted(axis_of) != list(range(self.N)):
            raise ValueError(f"axis_of must be a permutation of 0..{self.N - 1}")
        if self.fusion_mode != "slab" and axis_of != list(range(self.N)):
            re, im = (np.ascontiguousarray(
                x.reshape((2,) * self.N).transpose(axis_of)).reshape(-1)
                for x in (re, im))
            axis_of = list(range(self.N))
        self.re = self.im = None  # free the old planes first
        self.re = torch.from_numpy(re.copy()).to(self.device)
        self.im = torch.from_numpy(im.copy()).to(self.device)
        self.axis_of = axis_of
        return self

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """(re, im, axis_of): planes in physical order and the layout."""
        return (self.re.cpu().numpy(), self.im.cpu().numpy(),
                list(self.axis_of))

    # -- scheduling ------------------------------------------------------
    def _bit(self, qubit: int) -> int:
        """Amplitude-bit position of a big-endian qubit index."""
        return self.N - qubit - 1

    @staticmethod
    def _normalize(g) -> tuple[np.ndarray, tuple[int, ...]]:
        """(matrix, targets) with Insert-style injections unitarised.

        A 2-vector (a, b) means state injection: the register is fixed and
        the target starts in |0>, so the injection is the state-prep
        unitary [[a, -b*], [b, a*]].
        """
        mat, targets = g if isinstance(g, tuple) else (g.matrix, tuple(g.indices))
        mat = np.asarray(mat)
        if mat.size == 2:
            a, b = mat.reshape(2)
            mat = np.array([[a, -np.conj(b)], [b, np.conj(a)]])
        return mat, tuple(int(t) for t in targets)

    def _windows(self, gates):
        """Fuse ``gates`` into windows; in slab mode additionally schedule
        them with the layout planner (exact commuting reorder + adjacent
        merge) unless ``plan_windows`` is off."""
        max_bits = (self.slab_bits if self.fusion_mode == "slab"
                    else min(fusion.MAX_WINDOW_BITS, self.N))
        normalized = [self._normalize(g) for g in gates]
        windows = fusion.fuse_windows(normalized, max_bits=max_bits)
        if self.fusion_mode == "slab" and self.plan_windows:
            windows = order_windows(windows, self.N, self.slab_bits,
                                    self.scatter_move_max, self.axis_of)
            windows = fusion.merge_adjacent_windows(windows,
                                                    max_bits=max_bits)
        return windows

    def _plan(self, gates) -> list[_Plan]:
        """Chain-mode planner (the JAX engine's, unchanged): runs of fusable
        1q gates form one chain of at most 24, adjacent pairs whose inner
        stride is >= 128 a "2q" step, everything else an "xla" step."""
        plans: list[_Plan] = []
        chain: _Plan | None = None
        for g in gates:
            mat, targets = self._normalize(g)
            k = len(targets)
            bit = self._bit(targets[0])
            if k == 1 and bit in self._fusable:
                if chain is None or \
                        len(chain.bits) >= gate_kernels._MAX_CHAIN_LEN:
                    chain = _Plan("chain")
                    plans.append(chain)
                chain.matrices.append(mat)
                chain.bits.append(bit)
                continue
            chain = None
            if (k == 2 and targets[1] == targets[0] + 1
                    and self.N - targets[0] - 2 >= 7):
                plans.append(_Plan("2q", matrices=[mat], targets=targets))
            else:
                plans.append(_Plan("xla", matrices=[mat], targets=targets))
        return plans

    def _plane(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    # -- execution -------------------------------------------------------
    def run(self, gates) -> "FastStatevector":
        """Apply a sequence of gate objects (``.matrix`` + ``.indices``) or
        ``(matrix, targets)`` tuples: one window at a time (slab, window)
        or one planned step at a time (chain). Returns self."""
        if self.fusion_mode == "chain":
            return self._run_chain(gates)
        if self.fusion_mode == "window":
            self._require_identity_layout()
        with span("op:sv_plan"):
            windows = self._windows(gates)
        for u, tgts in windows:
            if self.fusion_mode == "slab":
                self._apply_slab_window(u, tgts)
            else:
                self.re, self.im = fusion.apply_window_split(
                    self.re, self.im, self._plane(u.real),
                    self._plane(u.imag), tgts, self.N)
        return self

    def _run_chain(self, gates) -> "FastStatevector":
        """Chain mode: each planned step is one kernel launch on CUDA (in
        place), its plain version on the CPU. A single-qubit general step
        runs the ``apply_1q`` kernel, which has no lane rule on the GPU;
        the plan itself stays the JAX engine's."""
        self._require_identity_layout()
        for plan in self._plan(gates):
            if plan.kind == "chain":
                self.re, self.im = gate_kernels.apply_1q_chain(
                    self.re, self.im, np.stack(plan.matrices),
                    tuple(plan.bits), self.N)
            elif plan.kind == "2q":
                self.re, self.im = gate_kernels.apply_2q_adjacent(
                    self.re, self.im, plan.matrices[0], plan.targets[0],
                    self.N)
            elif len(plan.targets) == 1:
                self.re, self.im = gate_kernels.apply_1q(
                    self.re, self.im, plan.matrices[0], plan.targets[0],
                    self.N)
            else:
                self.re, self.im = _apply_xla_general(
                    self.re, self.im, plan.matrices[0], plan.targets, self.N)
        return self

    def _run_pass(self, op: tuple):
        """One layout pass, plane after plane. The engine drops its own
        reference first, so each copy frees the plane it read: at most
        three planes are live."""
        copies = _layout_copies(op, self.N, self.slab_bits)
        with span("op:sv_layout"):
            for name in ("re", "im"):
                x = getattr(self, name)
                setattr(self, name, None)
                for shape, perm in copies:
                    x = _permute_copy(x, shape, perm)  # the old x is freed here
                setattr(self, name, x)
        n = 2 * len(copies)  # both planes
        self.plane_copies += n
        self.layout_bytes += n * 2 * self.re.numel() * self.re.element_size()  # read + write

    def _ensure_slab_resident(self, tgts: tuple[int, ...]):
        """Bring all target axes into the minor slab (lazy layout).

        Pass selection lives in :func:`plan_slab_residency`; here each
        emitted pass either runs on the planes or is recorded by
        ``run_compiled``'s plan-only hook. Windows already resident pay
        nothing.
        """
        N, S = self.N, self.slab_bits
        phys = [self.axis_of[t] for t in tgts]

        def emit(op, newpos):
            self.layout_passes += 1
            if self._plan_only is not None:
                self._plan_only(op)
            else:
                self._run_pass(op)
            self.axis_of = [newpos(p) for p in self.axis_of]

        plan_slab_residency(N, S, self.scatter_move_max, phys, emit)

    def _slab_window(self, u: np.ndarray, tgts: tuple[int, ...]):
        """The window expanded to the full slab, transposed, as float32
        ``(wt_re, wt_im)`` on the device. Targets must be slab-resident."""
        S = self.slab_bits
        positions = [self.axis_of[t] - (self.N - S) for t in tgts]
        w_slab = fusion._np_expand(np.asarray(u, np.complex128), S, positions)
        return self._plane(w_slab.real.T), self._plane(w_slab.imag.T)

    def _apply_slab_window(self, u: np.ndarray, tgts: tuple[int, ...]):
        """Apply one fused window with the lazy-layout slab scheme: move
        the targets into the slab (they stay), then one in-place
        ``(R, 2^S) @ (2^S, 2^S)`` split-real product."""
        self._ensure_slab_resident(tgts)
        wt_re, wt_im = self._slab_window(u, tgts)
        self._launch_window(wt_re, wt_im)

    def _launch_window(self, wt_re: torch.Tensor, wt_im: torch.Tensor):
        """One ``slab_matmul`` of a slab window already on the device."""
        with span("op:sv_window"):
            self.re, self.im = slab_kernels.slab_matmul(self.re, self.im,
                                                        wt_re, wt_im)
        self.slab_windows += 1

    def run_compiled(self, gates) -> "FastStatevector":
        """Slab-mode execution of a whole gate list from one recorded plan.

        The plan (layout passes + slab windows) is made first on a shadow
        layout table, exactly as the JAX engine traces it into one program,
        then run in one host loop. Same result and ``layout_passes`` as
        :meth:`run`. If planning fails, the layout table and pass count
        roll back; the planes are not touched before the plan is complete.
        """
        if self.fusion_mode != "slab":
            raise ValueError("run_compiled requires fusion_mode='slab'")
        plan: list[tuple] = []
        saved_layout = list(self.axis_of)
        saved_passes = self.layout_passes
        with span("op:sv_plan"):
            windows = self._windows(gates)
            self._plan_only = plan.append
            try:
                for u, tgts in windows:
                    self._ensure_slab_resident(tgts)
                    plan.append(("matmul",) + self._slab_window(u, tgts))
            except BaseException:
                self.axis_of = saved_layout
                self.layout_passes = saved_passes
                raise
            finally:
                self._plan_only = None
        for op in plan:
            if op[0] == "matmul":
                self._launch_window(op[1], op[2])
            else:
                self._run_pass(op)
        return self

    def _layout_is_identity(self) -> bool:
        return self.axis_of == list(range(self.N))

    def _require_identity_layout(self):
        """Window and chain mode apply each gate to the axis of its logical
        index, so they refuse a state whose layout is not the identity."""
        if not self._layout_is_identity():
            raise ValueError(f"fusion_mode={self.fusion_mode!r} needs the "
                             f"identity layout, got axis_of={self.axis_of}")

    # -- readout ---------------------------------------------------------
    def _p(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def norm_sq(self) -> float:
        with span("op:sv_readout"):
            return float(torch.sum(self.re * self.re) + torch.sum(self.im * self.im))

    def amplitudes(self, logical_indices) -> np.ndarray:
        """Amplitudes of the LOGICAL basis states ``logical_indices`` (int64,
        big-endian: qubit l is bit N - 1 - l) as complex64 on the host — any
        N, any slab layout, without the rank-N transpose: each index is
        mapped to its physical index through ``axis_of`` and ``re``/``im``
        are gathered at those on the device."""
        idx = np.asarray(logical_indices, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= 1 << self.N):
            raise ValueError(f"basis indices must lie in [0, 2**{self.N})")
        with span("op:sv_readout"):
            phys = torch.from_numpy(idx).to(self.device)
            if not self._layout_is_identity():
                phys = _remap_basis(phys, self.axis_of, to_physical=True)
            return torch.complex(self.re[phys], self.im[phys]).cpu().numpy()

    def probs(self) -> torch.Tensor:
        """|amp|^2 vector in LOGICAL qubit order — any layout.

        Identity layouts are free. Permuted layouts at N <= 22 use the
        rank-N transpose; larger N a RUN-GROUPED transpose: the logical
        order is a permutation of maximal physical-axis runs, so the view
        rank is the run count. A layout with more than 16 runs is refused —
        use :meth:`marginal` for subset readout there.
        """
        p = self._p()
        if self._layout_is_identity():
            return p
        perm = list(self.axis_of)
        if self.N <= 22:
            return p.reshape((2,) * self.N).permute(perm).reshape(-1)
        # maximal runs of consecutive physical axes in the logical order
        runs = [[perm[0]]]
        for a in perm[1:]:
            if a == runs[-1][-1] + 1:
                runs[-1].append(a)
            else:
                runs.append([a])
        if len(runs) > 16:
            raise ValueError(
                f"probs() on a {len(runs)}-run permuted layout at N={self.N} "
                "would need a high-rank transpose; read a subset via "
                "marginal() instead")
        starts = sorted(range(len(runs)), key=lambda i: runs[i][0])
        shape = tuple(1 << len(runs[i]) for i in starts)
        tperm = tuple(starts.index(i) for i in range(len(runs)))
        return p.reshape(shape).permute(tperm).reshape(-1)

    def marginal(self, qubits) -> torch.Tensor:
        """Joint Born distribution of LOGICAL ``qubits`` (in the order
        given) — any N, any slab layout. Returns a (2^k,) vector,
        big-endian in ``qubits``.

        One grouped reduction: |amp|^2 reshaped to the interleaved-segment
        view of the qubits' physical axes (rank <= 2k+1) and summed over
        the complementary segments, then reordered to the requested order.
        """
        qs = list(qubits)
        if len(set(qs)) != len(qs):
            raise ValueError(f"duplicate qubits in marginal: {qs}")
        if not all(0 <= q < self.N for q in qs):
            raise ValueError(f"qubits out of range for N={self.N}: {qs}")
        if len(qs) > 16:
            raise ValueError("marginal() of more than 16 qubits")
        pos = [self.axis_of[q] for q in qs]
        order = sorted(range(len(pos)), key=lambda i: pos[i])
        spos = tuple(pos[i] for i in order)
        shape, taxes = fusion._grouped_view(self.N, spos)
        others = tuple(i for i in range(len(shape)) if i not in taxes)
        # result axis j holds qubit qs[order[j]]; put qs[i] at axis i
        inv = tuple(order.index(i) for i in range(len(qs)))
        p = self._p().reshape(shape)
        if others:  # torch sums over ALL axes for an empty dim list
            p = torch.sum(p, dim=others)
        return p.permute(inv).reshape(-1)

    def probabilities(self, qubit: int) -> torch.Tensor:
        """Marginal (p0, p1) of one LOGICAL qubit — any N, any slab layout,
        by one reduction over the axes around its physical position."""
        if not 0 <= qubit < self.N:
            raise ValueError(f"qubit {qubit} out of range for N={self.N}")
        pos = self.axis_of[qubit]
        lead = 1 << pos                      # axes above the target bit
        trail = 1 << (self.N - 1 - pos)      # axes below
        return torch.sum(self._p().reshape(lead, 2, trail), dim=(0, 2))

    def sample(self, generator: torch.Generator, shots: int = 1) -> np.ndarray:
        """Terminal Born sampling of all qubits: (shots,) basis indices in
        LOGICAL order.

        Two-stage exact factorisation — a categorical over row sums
        (marginal of the leading N - c_bits bits), then one over the chosen
        row — so no 2^N-category draw is made (``torch.multinomial`` takes
        at most 2^24 categories); at N = 30 the draws are over 2^19 rows
        and 2^11 columns. ``generator`` must live on the engine's device.
        """
        C = 1 << self.c_bits
        R = (1 << self.N) // C
        with span("op:sv_readout"):
            p = self._p().reshape(R, C)
            rows = torch.sum(p, dim=1)
            r = torch.multinomial(rows, shots, replacement=True,
                                  generator=generator)
            c = torch.multinomial(p[r], 1, generator=generator).squeeze(1)
            samples = (r * C + c).cpu().numpy()
        if self._layout_is_identity():
            return samples
        # slab layout: sampled indices are in PHYSICAL axis order — remap
        # each bit to its logical position (host-side, (shots,) ints)
        return _remap_basis(samples, self.axis_of, to_physical=False)
