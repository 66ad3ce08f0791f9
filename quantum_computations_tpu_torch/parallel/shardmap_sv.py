"""Explicit-collective sharded state vector (counterpart of
``quantum_computations_tpu/parallel/shardmap_sv.py``).

The index-swap scheme of distributed simulators (cf. mpiQulacs,
arXiv:2203.16044) on ``torch.distributed``:

- the 2^N state lives as D = 2^k blocks of 2^(N-k) amplitudes, one per rank
  of a mesh (:mod:`.mesh`); the k rank-index bits are GLOBAL qubit slots
  (most significant first: rank r is the JAX engine's device r of its 1-D
  mesh), the remaining N-k bits LOCAL slots;
- gates on local slots are per-rank contractions with no communication;
- a gate on a global slot first SWAPS that slot with a local slot through
  one pairwise exchange (each rank trades half its block with the partner
  that differs in that rank bit). The swap is LAZY: the engine keeps the
  new layout and updates its logical->physical table, so later gates on the
  moved qubits communicate no more.

Differences from the JAX package, all deliberate: ``self.state`` is this
rank's block, shape (2^(N-k),); the pairwise exchange is one
``all_to_all_single`` over the mesh in place of the tiled pair
``all_to_all``; :meth:`ShardMapStateVector.run_fused_slab` makes its plan on
a shadow layout table and runs it in one host loop with no program cache
(the plan of the last call is ``last_plan``); sampling and measurement draw
from ``torch.Generator``s, with the outcome drawn on rank 0 and broadcast.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import complex_dtype, full_fp32_matmul
from ..dv import fast_sv, fusion, qop
from .mesh import Mesh, data_mesh

__all__ = ["ShardMapStateVector", "agreed_outcome", "pair_swap"]

_SAMPLE_COLUMN_BITS = 11  # two-stage local draws: rows, then 2^11 columns


def pair_swap(mesh: Mesh, block: torch.Tensor, k: int, global_slot: int,
              j: int):
    """Swap global slot ``global_slot`` (rank bit, MSB first of ``k``) with
    local bit ``j`` (MSB first) of every rank's ``block``, in place.

    A rank whose bit is b keeps its half b of local bit j and receives its
    partner's half b into its half 1 - b: one pairwise exchange of half a
    block per rank."""
    L = int(block.numel()).bit_length() - 1
    shift = k - 1 - global_slot
    bit = (mesh.rank >> shift) & 1
    view = block.view(1 << j, 2, 1 << (L - j - 1))
    recv = mesh.exchange(view[:, 1 - bit], mesh.rank ^ (1 << shift))
    view[:, 1 - bit] = recv.view(1 << j, -1)


def agreed_outcome(mesh: Mesh, p0: float, p1: float,
                   generator: torch.Generator | None,
                   result: int | None) -> tuple[int, float]:
    """(outcome, its probability) of a Z measurement with marginals (p0,
    p1), the same on every rank: ``result``, else drawn on rank 0 from
    ``generator`` (Bernoulli(p1 / (p0 + p1))), and broadcast."""
    if result is not None:
        outcome = int(result)
    elif generator is None:
        raise ValueError("Measurement requires a torch.Generator "
                         "(pass generator=...).")
    elif mesh.rank == 0:
        u = torch.rand((), generator=generator, dtype=torch.float64,
                       device=generator.device)
        outcome = int(u.item() < p1 / (p0 + p1))
    else:
        outcome = 0  # replaced by rank 0's draw below
    t = torch.tensor([outcome, p1 if outcome else p0], dtype=torch.float64,
                     device=mesh.device)
    outcome, prob = mesh.broadcast(t, 0).tolist()
    return int(outcome), prob


class ShardMapStateVector:
    """N-qubit state vector over D = 2^k ranks with explicit collectives.

    ``self.slot_of[q]`` gives the current physical slot of logical qubit q:
    slots 0..k-1 are rank bits (MSB first), slots k..N-1 local bits.
    ``mesh``: a :class:`.mesh.Mesh` of 2^k ranks (default: every rank of
    the world, or a world of one); ``device`` is used only without one.
    Every rank calls every method in the same order.
    """

    SCATTER_MOVE_MAX = 21  # larger per-rank blocks use only minor-safe passes
    A2A_PASS_COST = 4      # scheduler weight: one collective swap vs one local pass

    def __init__(self, N: int, mesh: Mesh | None = None, *, device=None):
        self.mesh = mesh if mesh is not None else data_mesh(device=device)
        self.D = self.mesh.size
        self.k = self.D.bit_length() - 1
        if 1 << self.k != self.D:
            raise ValueError(f"the rank count {self.D} is not a power of two")
        self.N = N
        self.L = N - self.k
        self.device = self.mesh.device
        self.dtype = complex_dtype(self.device)
        self.slot_of = list(range(N))  # identity layout initially
        # read once at construction, as FastStatevector reads it
        self.plan_windows = os.environ.get("QCT_SV_PLAN", "1") != "0"
        self.last_plan: tuple = ()
        self.exchanges = 0  # pairwise exchanges run so far
        self.state = torch.zeros(1 << self.L, dtype=self.dtype,
                                 device=self.device)
        if self.mesh.rank == 0:
            self.state[0] = 1.0

    # -- carrying state across ---------------------------------------------
    def load_numpy(self, blocks: np.ndarray, slot_of) -> "ShardMapStateVector":
        """Take the JAX engine's ``(D, 2^L)`` state (this rank keeps its
        block) and its layout table ``slot_of``. Returns self."""
        blocks = np.asarray(blocks)
        if blocks.shape != (self.D, 1 << self.L):
            raise ValueError(f"blocks must have shape {(self.D, 1 << self.L)}, "
                             f"got {blocks.shape}")
        slot_of = [int(s) for s in slot_of]
        if sorted(slot_of) != list(range(self.N)):
            raise ValueError(f"slot_of must be a permutation of 0..{self.N - 1}")
        self.state = torch.from_numpy(np.ascontiguousarray(
            blocks[self.mesh.rank])).to(self.device, self.dtype)
        self.slot_of = slot_of
        return self

    # -- layout helpers -----------------------------------------------------
    def _local_view_axes(self, local_slot: int):
        """(pre, post) of the (pre, 2, post) view of a local slot."""
        j = local_slot - self.k
        return 1 << j, 1 << (self.L - j - 1)

    def _op(self, matrix) -> torch.Tensor:
        return torch.as_tensor(np.asarray(matrix)).to(self.device, self.dtype)

    # -- collective swap ----------------------------------------------------
    def _swap_global_local(self, global_slot: int, local_slot: int):
        """Exchange a rank-bit slot with a local slot (one exchange)."""
        pair_swap(self.mesh, self.state, self.k, global_slot,
                  local_slot - self.k)
        self.exchanges += 1
        # lazy layout update: the two slots' occupants exchange places
        qg = self.slot_of.index(global_slot)
        ql = self.slot_of.index(local_slot)
        self.slot_of[qg], self.slot_of[ql] = local_slot, global_slot

    def _ensure_local(self, qubits: tuple[int, ...]):
        """Swap any globally stored target qubits into local slots."""
        for q in qubits:
            slot = self.slot_of[q]
            if slot < self.k:
                # Victim: the local slot whose occupant has the highest
                # logical index among non-targets, heuristically the least
                # active qubit, so hot qubits settle into local slots.
                target_slots = {self.slot_of[t] for t in qubits}
                candidates = [s for s in range(self.k, self.N)
                              if s not in target_slots]
                victim = max(candidates, key=lambda s: self.slot_of.index(s))
                self._swap_global_local(slot, victim)

    # -- gates --------------------------------------------------------------
    @full_fp32_matmul()
    def apply(self, matrix, qubits: tuple[int, ...]):
        """Apply a 1- or 2-qubit unitary to logical ``qubits``."""
        if len(qubits) not in (1, 2):
            raise NotImplementedError("1- and 2-qubit gates only")
        self._ensure_local(qubits)
        slots = tuple(self.slot_of[q] for q in qubits)
        u = self._op(matrix)
        if len(qubits) == 1:
            pre, post = self._local_view_axes(slots[0])
            x = self.state.view(pre, 2, post)
            self.state = torch.einsum("bc,acj->abj", u, x).reshape(-1)
            return self
        s1, s2 = slots
        lo, hi = sorted(slots)
        u4 = u.reshape(2, 2, 2, 2)
        if s1 > s2:
            u4 = u4.permute(1, 0, 3, 2)
        jlo, jhi = lo - self.k, hi - self.k
        x = self.state.view(1 << jlo, 2, 1 << (jhi - jlo - 1), 2,
                            1 << (self.L - jhi - 1))
        self.state = torch.einsum("xyce,ocmei->oxmyi", u4, x).reshape(-1)
        return self

    def apply_window(self, u, qubits: tuple[int, ...]):
        """Apply a fused k-qubit window unitary (k <= local bits).

        No communication once the targets are local: one grouped einsum
        per block (:func:`..dv.fusion.apply_window`). ``u`` rows/cols index
        the qubits of ``qubits`` in the given order.
        """
        qubits = tuple(int(q) for q in qubits)
        if len(qubits) > self.L:
            raise ValueError(f"window of {len(qubits)} qubits exceeds the "
                             f"{self.L} local bits per rank")
        self._ensure_local(qubits)
        slots = [self.slot_of[q] for q in qubits]
        order = list(np.argsort(slots))
        u = np.asarray(u)
        if order != list(range(len(qubits))):
            # re-order the operator's tensor factors to ascending slot
            # order: old factor i moves to its slot's rank
            ranks = [int(r) for r in np.argsort(order)]
            u = qop.permute_tensor_product(u, ranks).numpy()
        tgts = tuple(sorted(s - self.k for s in slots))
        self.state = fusion.apply_window(self.state, u, tgts, self.L)
        return self

    def run_fused(self, gates, max_bits: int | None = None):
        """Fuse a unitary gate list into window unitaries and apply them.

        ``gates``: (matrix, qubits) tuples or gate objects, as accepted by
        :func:`..dv.fusion.fuse_windows`. Windows are capped at the local
        bit count, so each applies without communication after its
        layout swaps.
        """
        mb = fusion.MAX_WINDOW_BITS if max_bits is None else int(max_bits)
        for u, tgts in fusion.fuse_windows(gates, max_bits=min(mb, self.L)):
            self.apply_window(u, tgts)
        return self

    # -- fused slab execution -------------------------------------------------
    def _plan_window_residency(self, slot_of: list[int],
                               qubits: tuple[int, ...], S: int,
                               plan: list[tuple]) -> list[int]:
        """Append to ``plan`` the collective swaps and minor-safe local
        passes that make logical ``qubits`` minor-slab resident from layout
        ``slot_of``; returns the updated layout (input not mutated).

        Pure planning over the slot table, shared by the plan that runs and
        the window scheduler's cost simulation.
        """
        L, k, N = self.L, self.k, self.N
        slab_start_slot = N - S
        slot_of = list(slot_of)
        # 1) collective swaps bring global targets into local slots
        for q in qubits:
            slot = slot_of[q]
            if slot >= k:
                continue
            tslots = {slot_of[t] for t in qubits}
            cands = [s for s in range(k, N) if s not in tslots]
            # prefer victims outside the minor slab (resident windows stay
            # resident); tie-break: the least active (highest logical
            # index) occupant, as in _ensure_local
            outside = [s for s in cands if s < slab_start_slot]
            victim = max(outside or cands, key=lambda s: slot_of.index(s))
            plan.append(("a2a", slot, victim - k))
            qg = slot_of.index(slot)
            ql = slot_of.index(victim)
            slot_of[qg], slot_of[ql] = victim, slot
        # 2) minor-safe local passes park the targets in the slab
        phys = [slot_of[q] - k for q in qubits]

        def emit(op, newpos):
            plan.append(op)
            slot_of[:] = [k + newpos(s - k) if s >= k else s for s in slot_of]

        fast_sv.plan_slab_residency(L, S, self.SCATTER_MOVE_MAX, phys, emit)
        return slot_of

    def run_fused_slab(self, gates, max_bits: int | None = None,
                       plan_windows: bool | None = None):
        """A whole fused circuit as one plan over the mesh.

        The sharded twin of :meth:`..dv.fast_sv.FastStatevector.run_compiled`:
        every block keeps a 2^S-wide minor slab with a lazy logical->physical
        layout, windows apply as ``(R, 2^S) @ (2^S, 2^S)`` products, and
        layout moves use only minor-safe passes
        (:func:`..dv.fast_sv.plan_slab_residency`). The plan (collective
        swaps, local layout passes, slab products) is made on a shadow
        layout table, kept as ``last_plan`` (without the matrices), then run
        in one host loop. The final layout lands in ``self.slot_of``; every
        readout method reads through it.
        """
        L, k, N = self.L, self.k, self.N
        S = min(fusion.MAX_WINDOW_BITS if max_bits is None else int(max_bits), L)
        normalized = []
        for g in gates:
            mat, tgts = g if isinstance(g, tuple) else (g.matrix, tuple(g.indices))
            normalized.append((np.asarray(mat), tuple(int(t) for t in tgts)))
        if any(len(t) > S for _, t in normalized):
            raise ValueError(f"gate support exceeds the {S}-bit slab")
        windows = fusion.fuse_windows(normalized, max_bits=S)
        if plan_windows is None:
            plan_windows = self.plan_windows
        if plan_windows:
            # commutation-exact scheduling: minimise collective swaps
            # (weighted A2A_PASS_COST) plus local layout passes, then merge
            # now-adjacent windows into single products
            def cost_fn(slot_of, tgts):
                sim: list[tuple] = []
                after = self._plan_window_residency(slot_of, tgts, S, sim)
                return (sum(self.A2A_PASS_COST if op[0] == "a2a" else 1
                            for op in sim), after)

            windows = fast_sv.order_windows_by_cost(windows, list(self.slot_of),
                                                    cost_fn)
            windows = fusion.merge_adjacent_windows(windows, max_bits=S)

        plan: list[tuple] = []
        mats: list[torch.Tensor] = []
        slot_of = list(self.slot_of)
        for u, qubits in windows:
            slot_of = self._plan_window_residency(slot_of, qubits, S, plan)
            positions = [slot_of[q] - k - (L - S) for q in qubits]
            w = fusion._np_expand(np.asarray(u, np.complex128), S, positions)
            plan.append(("matmul",))
            mats.append(self._op(np.ascontiguousarray(w.T)))
        self.last_plan = tuple(plan)
        d = 1 << S
        # the engine drops its reference, so each pass frees the block it read
        x, self.state = self.state, None
        with full_fp32_matmul():
            for op in plan:
                if op[0] == "a2a":
                    pair_swap(self.mesh, x, k, op[1], op[2])
                    self.exchanges += 1
                elif op[0] == "swap":
                    x = fast_sv._block_swap_raw(x, L, S)
                elif op[0] == "move":
                    x = fast_sv._upper_move_raw(x, op[1], L, S, op[2])
                elif op[0] == "scatter":
                    x = fast_sv._move_axes_raw(x, op[1], L)
                else:
                    x = (x.view(-1, d) @ mats.pop(0)).view(-1)
        self.state = x
        self.slot_of = slot_of
        return self

    # -- observables --------------------------------------------------------
    def _mass(self) -> torch.Tensor:
        return torch.sum(self.state.real ** 2 + self.state.imag ** 2)

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.mesh.all_reduce(self._mass()))

    def probabilities(self, qubit: int) -> torch.Tensor:
        """Marginal (p0, p1) of a logical qubit (any layout), on every rank."""
        slot = self.slot_of[qubit]
        if slot < self.k:
            bit = (self.mesh.rank >> (self.k - 1 - slot)) & 1
            p = torch.zeros(2, dtype=self.state.real.dtype, device=self.device)
            p[bit] = self._mass()
            return self.mesh.all_reduce(p)
        pre, post = self._local_view_axes(slot)
        x = self.state.view(pre, 2, post)
        return self.mesh.all_reduce(torch.sum(x.real ** 2 + x.imag ** 2, (0, 2)))

    # -- measurement / sampling ----------------------------------------------
    def _project_z(self, qubit: int, outcome: int, prob: float):
        """Collapse ``qubit`` onto Z eigenstate ``outcome`` and renormalise,
        in place and without communication."""
        slot = self.slot_of[qubit]
        if slot < self.k:
            if ((self.mesh.rank >> (self.k - 1 - slot)) & 1) != outcome:
                self.state.zero_()
        else:
            pre, post = self._local_view_axes(slot)
            self.state.view(pre, 2, post)[:, 1 - outcome].zero_()
        self.state.mul_(1.0 / np.sqrt(prob))

    def measure(self, qubit: int, generator: torch.Generator | None = None, *,
                theta: float = 0.0, phi: float = 0.0,
                result: int | None = None) -> int:
        """Projective measurement along the (theta, phi) axis with collapse.

        The DV engine's ``M`` semantics: Born probabilities along the axis,
        an outcome drawn on rank 0 from ``generator`` (or post-selected by
        ``result``) and broadcast, the state projected onto the outcome
        eigenvector and renormalised. A general axis is a basis change:
        apply U^dagger, project in Z, apply U back. Returns the outcome.
        """
        rotated = (theta, phi) != (0.0, 0.0)
        if rotated:
            u = (qop.axis_rotation(phi, [0, 0, 1])
                 @ qop.axis_rotation(theta, [0, 1, 0]))
            self.apply(np.conj(u).T, (qubit,))
        outcome, prob = agreed_outcome(self.mesh, *self.probabilities(qubit).tolist(),
                                       generator, result)
        self._project_z(qubit, outcome, prob)
        if rotated:
            self.apply(u, (qubit,))
        return outcome

    def sampling_distribution(self) -> tuple[np.ndarray, torch.Tensor]:
        """The two stages of :meth:`sample`: the ranks' masses (D,) float64
        on the host, and this rank's local distribution |block|^2 / mass
        (physical local order; zeros where the mass is 0)."""
        p = self.state.real ** 2 + self.state.imag ** 2
        mass = torch.sum(p, dtype=torch.float64)
        masses = self.mesh.all_gather(mass.reshape(1)).cpu().numpy()
        local = p / mass.to(p.dtype) if mass > 0 else p
        return masses, local

    def sample(self, generator: torch.Generator, num_samples: int) -> np.ndarray:
        """Born-sample ``num_samples`` bitstrings without collapsing the state.

        Two-stage ancestral sampling that never gathers the 2^N
        distribution: every rank draws local indices from its block's
        distribution (rows of 2^11 amplitudes, then a column) with a
        generator of its own, seeded from ``generator`` on rank 0 plus its
        rank; the masses are gathered and the rank of each draw is picked
        on the host from ``generator`` on rank 0 and broadcast.
        Communication is O(D * num_samples) numbers, independent of N.

        Returns an (num_samples, N) int8 array in LOGICAL qubit order, the
        same on every rank.
        """
        n = int(num_samples)
        masses, local = self.sampling_distribution()
        seed = torch.zeros(1, dtype=torch.int64, device=self.device)
        if self.mesh.rank == 0:
            seed[0] = int(torch.randint(1 << 62, (1,), generator=generator))
        seed = int(self.mesh.broadcast(seed, 0).item()) + self.mesh.rank
        own = torch.Generator(device=self.device)
        own.manual_seed(seed)
        idx = torch.zeros(n, dtype=torch.int64, device=self.device)
        if masses[self.mesh.rank] > 0:
            C = 1 << min(_SAMPLE_COLUMN_BITS, self.L)
            p = local.view(-1, C)
            r = torch.multinomial(torch.sum(p, 1), n, replacement=True,
                                  generator=own)
            c = torch.multinomial(p[r], 1, generator=own).squeeze(1)
            idx = r * C + c
        local_idx = self.mesh.all_gather(idx[None]).cpu().numpy()  # (D, n)
        dev = torch.zeros(n, dtype=torch.int64, device=self.device)
        if self.mesh.rank == 0:
            w = torch.from_numpy(masses / masses.sum())
            dev[:] = torch.multinomial(w, n, replacement=True,
                                       generator=generator).to(self.device)
        dev = self.mesh.broadcast(dev, 0).cpu().numpy()
        flat = dev * (1 << self.L) + local_idx[dev, np.arange(n)]
        # physical-slot bits (MSB first) -> logical qubit order
        bits = (flat[:, None] >> (self.N - 1 - np.arange(self.N))[None, :]) & 1
        return bits[:, [self.slot_of[q] for q in range(self.N)]].astype(np.int8)

    def to_dense(self) -> np.ndarray:
        """Gather the full state in LOGICAL qubit order (testing only), on
        every rank."""
        flat = self.mesh.all_gather(self.state).cpu().numpy()
        t = flat.reshape((2,) * self.N)
        # out axis q comes from the physical slot holding qubit q
        return np.transpose(t, [self.slot_of[q] for q in range(self.N)]).reshape(-1)
