"""Batched GKP trajectory engine (counterpart of
``quantum_computations_tpu/gkp/batched.py``).

``BatchedGKP(qs, epsilon, svd_options, adaptive=True, granularity="op")``
runs a batch of trajectories of one transpiled circuit: the chain tensors
carry a leading trajectory axis (B, l, d, r) and live on the device; the
Pauli frame, the syndromes and the classical feed-forward live on the
host as small numpy integer arrays.

Production path (the defaults): every single-mode gadget runs through the
SVD-free :func:`..ops.fused_gadget.fused_single_gadget`; a two-mode
(macronode) gadget is two Bell splices, two beamsplitter splits and two
:func:`..ops.fused_gadget.fused_pair_measure2`; with ``adaptive`` every
bond is trimmed between ops to the bucketed batch maximum of its measured
rank, which the host tracks (``track_ranks``) without a fetch of the whole
chain. The host waits for the device once per gadget (the syndrome
fetch), once per fused pair (its outcomes, with the absorbed bond's rank),
once per materialised split's rank and once per streamed split's Gram per
trajectory; a full (unrandomized) CUDA split adds its Gram's cuSOLVER
eigh, and so does a randomized split's pass of fewer than
``ops.linalg.KERNEL_MIN_BATCH`` trajectories or with a bond cap under 23
(a larger pass's Grams, of side 33 to 128, go to the one-launch
``ops.herm_eigh_small`` kernel, which does not wait; the split's rank
fetch checks that it converged).

Differences from the JAX package, all deliberate: one eager program in
place of cached jitted executors (no executor cache; the tests' witness
of the fused path and of rank tracking is :attr:`BatchedGKP.counts`);
``fused_single``, ``fused_pair`` and ``track_ranks`` default on with no
environment variable (``QCT_FUSED_SINGLE``, ``QCT_FUSED_PAIR``,
``QCT_RANK_TRACK``); one host ``torch.Generator`` per run in place of
per-op PRNG keys; syndromes decoded on the host in float64;
``run_circuit(data_sharding=)`` takes a 1-D rank mesh
(:func:`..parallel.data_mesh`) in place of a ``jax.sharding.Sharding``:
each rank runs its contiguous slice of the batch, draws through a
:class:`..utils.rng.BatchShard` what the serial run of the same seed draws
for those trajectories, and takes every rank bound the serial run takes
from its batch (the maximum over all ranks), so the rows equal the serial
rows trajectory for trajectory.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import SVDOptions, complex_dtype, resolve_device, to_device
from ..cv import gates as cvg
from ..dv import gates as dv_gates
from ..dv.simulator import ClassicalControl
from ..ops.fused_gadget import _grid, fused_pair_measure2, fused_single_gadget, pair_measure_path
from ..ops.linalg import fetch
from ..utils import as_generator
from ..utils.profiling import span
from ..utils.rng import BatchShard
from .compiled import (ARCTAN2, _bs_split, _homodyne, _insert_bell,
                       _single_gadget, _syndrome_from, _two_mode_gadget,
                       _two_mode_syndromes, bell_vectors, corrected_density,
                       gkp_basis, product_tensors)
from .gates import MB2Type
from .transpiler import MBGKPCircuit

__all__ = ["BatchedGKP"]


def _col_rank(t: torch.Tensor) -> torch.Tensor:
    """Batch maximum of a (B, l, d, r) tensor's measured right-bond rank
    (truncated directions are exact zeros: highest nonzero column + 1),
    a 0-d device tensor."""
    norms = torch.sum(t.real ** 2 + t.imag ** 2, (1, 2))          # (B, r)
    idx = torch.arange(1, t.shape[-1] + 1, device=t.device)
    return torch.amax(torch.where(norms > 0, idx, 0))


class BatchedGKP:
    def __init__(self, qs, ancilla_epsilon, svd_options: SVDOptions | dict | None = None,
                 *, adaptive: bool = False, granularity: str = "gadget",
                 fused_single: bool = True, fused_pair: bool = True,
                 track_ranks: bool = True, device=None):
        """adaptive=True enables rank-adaptive bond trimming: the batch
        maximum of each bond's measured rank is bucketed
        (:meth:`_trim_bucket`) and the tensors are sliced to it (and
        copied, so the untrimmed storage is freed).

        granularity: "gadget" runs a whole MB gadget per step, trimming
        between gadgets; "op" one CV operation per step with trimming
        BETWEEN ops, required at production bond dimensions.

        fused_single: every single-mode gadget through the SVD-free
        :func:`..ops.fused_gadget.fused_single_gadget`, whatever the
        granularity. fused_pair: the macronode's last two beamsplitters
        and their homodynes through :func:`..ops.fused_gadget.fused_pair_measure2`.
        track_ranks: on the production op path, the host tracks every
        bond's measured rank instead of fetching them all after each op.
        device: where the tensors live (default ``cuda``)."""
        if granularity not in ("gadget", "op"):
            raise ValueError(granularity)
        self.qs = np.asarray(qs)
        self.epsilon = ancilla_epsilon
        if isinstance(svd_options, dict):
            svd_options = SVDOptions(**svd_options)
        self.opts = svd_options or SVDOptions()
        self.adaptive = adaptive
        self.granularity = granularity
        self.fused_single = bool(fused_single)
        self.fused_pair = bool(fused_pair)
        self.track_ranks = bool(track_ranks)
        self.device = resolve_device(device)
        # Host-tracked measured bond ranks (bond j = right bond of tensor
        # j), kept during run_circuit on the production op path, where
        # every op that changes a rank is followed by a targeted trim:
        # - Bell splices insert structurally full bonds and modify no
        #   existing tensor;
        # - a streamed BS split returns its kept ranks on the host, a
        #   materialised one has them measured from its left factor alone
        #   (the other operand's bond is unitarily invariant, and
        #   zero-masked columns stay exact zeros);
        # - fused pair measures return the absorbed neighbour's rank with
        #   their outcomes;
        # - fused single gadgets act on the physical axis only, which
        #   keeps the zero-column mask exactly.
        self._ranks: list[int] | None = None
        self._generator: torch.Generator | None = None
        # (mesh, rows per rank) of the last run_circuit when it was data
        # sharded: the batch maxima and readout's gather go over the mesh
        self._shard = None
        self._basis: tuple[torch.Tensor, torch.Tensor] | None = None
        # Ops run, full and single-bond rank fetches, and the largest
        # bond pair (a, b) each kind of gadget or split met, since
        # construction.
        self.counts: collections.Counter = collections.Counter()
        self.largest: dict[str, tuple[int, int]] = {}

    @property
    def _tracking_active(self) -> bool:
        return (self.track_ranks and self.adaptive
                and self.granularity == "op"
                and self.fused_single and self.fused_pair)

    # ------------------------------------------------------------------
    def _gkp_basis(self) -> tuple[torch.Tensor, torch.Tensor]:
        """GKP |0>, |1> on the grid (complex128 on the device), formed once."""
        if self._basis is None:
            self._basis = gkp_basis(_grid(self.qs, self.device), float(self.epsilon))
        return self._basis

    def _bell(self, phase, dtype) -> torch.Tensor:
        """(B, d, 2) Bell vectors with second coefficient exp(i phase), one
        phase per trajectory."""
        return bell_vectors(self._gkp_basis(),
                            np.exp(1j * np.asarray(phase, np.float64)), dtype)

    def _note(self, kind: str, a: int, b: int):
        self.counts[kind] += 1
        if a * b > np.prod(self.largest.get(kind, (0, 0))):
            self.largest[kind] = (int(a), int(b))

    # ------------------------------------------------------------------
    def _single(self, tensors, idx, meas_a2, syn_a1, syn_a2, bell_phase,
                *, a1, a1_zero):
        """Single-mode gadget (I/P/T family and H): returns (tensors, (B, 2)
        host syndromes).

        a1 (one number) is the first measured angle; syn_a1/syn_a2 (one per
        trajectory) enter the syndrome formula, and differ from the measured
        angles only for Pauli-frame-flipped T gadgets.
        """
        if self.fused_single:
            return self._single_fused(tensors, idx, meas_a2, syn_a1, syn_a2,
                                      bell_phase, a1=a1)
        if self.granularity == "op":
            return self._single_ops(tensors, idx, meas_a2, syn_a1, syn_a2,
                                    bell_phase, a1=a1, a1_zero=a1_zero)
        with span("op:single"):
            tensors, synd = _single_gadget(
                tensors, idx, (a1, meas_a2),
                (syn_a1, syn_a2), self._bell(bell_phase, tensors[0].dtype),
                self.opts, self._generator, self.qs, a1_zero=a1_zero)
        return tensors, synd

    def _single_fused(self, tensors, idx, meas_a2, syn_a1, syn_a2, bell_phase,
                      *, a1):
        """SVD-free fused single-mode gadget (ops/fused_gadget.py): both
        homodynes drawn on the device, one fetch of the outcomes for the
        syndromes. Shape-preserving: no trim follows it."""
        self._note("fused_single", *tensors[idx].shape[1:4:2])
        with span("op:fused_single"):
            new_tensors, m1, m2 = fused_single_gadget(
                tensors, idx, self.qs, self._bell(bell_phase, tensors[0].dtype),
                a1, np.asarray(meas_a2), self._generator)
            ms = torch.stack([m1, m2], -1)
        with span("op:synd_fetch"):
            ms = ms.cpu().numpy()
        return new_tensors, _syndrome_from(syn_a1, syn_a2, ms[:, 0], ms[:, 1])

    # -- op-level steps (granularity="op") --------------------------------
    def _maybe_trim(self, tensors):
        return self._trim_tensors(tensors) if self.adaptive else tensors

    def _op_insert_bell(self, tensors, idx, bell_phase):
        self.counts["bell"] += 1
        with span("op:bell"):
            out = _insert_bell(tensors, idx, self._bell(bell_phase, tensors[0].dtype))
        if self._ranks is not None:
            # Splice tensors are identity-kron over the pass-through bond:
            # every column of both new bonds is nonzero (the Bell
            # coefficient is a unit phase), so the measured rank equals the
            # capacity and a trim is a no-op. No existing tensor changes.
            if idx < len(tensors):  # front/middle insert
                self._ranks[idx:idx] = [int(out[idx].shape[-1]),
                                        int(out[idx + 1].shape[-1])]
            else:
                # append: the new bonds are (old last <-> b_left), measured
                # from the unchanged old last tensor (edge capacity 1), and
                # (b_left <-> b_right)
                self._ranks.extend([int(out[idx - 1].shape[-1]),
                                    int(out[idx].shape[-1])])
            return out
        return self._maybe_trim(out)

    def _op_bs(self, tensors, i, j):
        li = min(i, j)
        a, d = tensors[li].shape[1:3]
        b = tensors[li + 1].shape[-1]
        kind = "bs_streamed" if cvg._use_streamed(a, d, b, self.opts) else "bs"
        self._note(kind, a, b)
        with span(f"op:{kind}"):
            out, ranks = _bs_split(tensors, i, j, self.opts, self._generator, self.qs)
        if self._ranks is not None:
            # a streamed split's kept ranks arrive on the host; the right
            # operand's own right bond is unitarily invariant and
            # zero-masked columns map to exact zeros
            self._ranks[li] = (self._batch_max(max(1, int(np.max(ranks))))
                               if ranks is not None
                               else self._bond_rank_single(out, li))
            return self._trim_with_ranks(out)
        return self._maybe_trim(out)

    def _op_homodyne(self, tensors, idx, angles, *, a_zero: bool):
        self.counts["homodyne"] += 1
        with span("op:homodyne"):
            out, m = _homodyne(tensors, idx, angles, self._generator, self.qs,
                               static_zero=a_zero)
        with span("op:homodyne_fetch"):
            m = m.cpu().numpy()
        return self._maybe_trim(out), m

    def _single_ops(self, tensors, idx, meas_a2, syn_a1, syn_a2, bell_phase,
                    *, a1, a1_zero):
        """Single-mode gadget composed of op-level steps with trims."""
        ones = np.ones(len(np.asarray(meas_a2)), np.float32)
        tensors = self._op_insert_bell(tensors, idx + 1, bell_phase)
        tensors = self._op_bs(tensors, idx, idx + 1)
        tensors, m_a = self._op_homodyne(tensors, idx, a1 * ones, a_zero=a1_zero)
        tensors, m_b = self._op_homodyne(tensors, idx, np.asarray(meas_a2), a_zero=False)
        return tensors, _syndrome_from(syn_a1, syn_a2, m_a, m_b)

    def _op_fused_pair(self, tensors, m, a1, a2):
        """Fused BS(m, m+1) + homodynes on both pair modes (one angle each)."""
        L0 = len(tensors)
        # The absorbing neighbour (fused_pair_measure2's smaller-intermediate
        # rule), an index into the pair-removed chain.
        a_dim, c_dim = tensors[m].shape[1], tensors[m + 1].shape[-1]
        has_left, has_right = m > 0, m + 2 < L0
        p = m - 1 if (has_left and (a_dim >= c_dim or not has_right)) else m
        # Only the absorbed tensor changes, so only its right bond's
        # measured rank can: it rides on the outcome fetch.
        want_rank = self._ranks is not None and p < L0 - 3
        path = pair_measure_path(a1, a2)
        self._note(f"fused_pair[{path}]", a_dim, c_dim)
        with span(f"op:fused_pair[{path}]"):
            out, m1, m2 = fused_pair_measure2(tensors, m, self.qs, a1, a2,
                                              self._generator)
            vals = [m1, m2]
            if want_rank:
                vals.append(_col_rank(out[p]).to(m1.dtype).expand(m1.shape[0]))
            packed = torch.stack(vals, -1)
        with span(f"op:fused_pair_fetch[{path}]"):
            packed = packed.cpu().numpy()
        if self._ranks is not None:
            rank = [self._batch_max(max(1, int(packed[0, 2])))] if want_rank else []
            nr = self._ranks
            if p == m - 1:
                self._ranks = nr[:m - 1] + rank + nr[m + 2:]
            else:
                self._ranks = nr[:m] + rank + nr[m + 3:]
            return self._trim_with_ranks(out), packed[:, 0], packed[:, 1]
        return self._maybe_trim(out), packed[:, 0], packed[:, 1]

    def _two_ops(self, tensors, idx, mb2type: MB2Type):
        """Macronode gadget composed of op-level steps with trims.

        Trimming between ops keeps every BS contraction at true-rank sizes.
        With ``fused_pair`` the third and fourth beamsplitters (whose
        operands are both measured at once) run through the SVD-free fused
        pair measure instead of a split and two homodynes."""
        ta, tc, tb, td = mb2type.angles()
        ones = np.ones(tensors[0].shape[0], np.float32)
        tensors = self._op_insert_bell(tensors, idx, 0.0 * ones)
        tensors = self._op_insert_bell(tensors, idx + 4, 0.0 * ones)
        tensors = self._op_bs(tensors, idx + 2, idx + 1)
        tensors = self._op_bs(tensors, idx + 3, idx + 4)
        if self.fused_pair:
            tensors, m_a, m_c = self._op_fused_pair(tensors, idx + 2, ta, tc)
            tensors, m_b, m_d = self._op_fused_pair(tensors, idx + 1, tb, td)
        else:
            tensors = self._op_bs(tensors, idx + 2, idx + 3)
            tensors, m_a = self._op_homodyne(tensors, idx + 2, ta * ones, a_zero=(ta == 0.0))
            tensors, m_c = self._op_homodyne(tensors, idx + 2, tc * ones, a_zero=(tc == 0.0))
            tensors = self._op_bs(tensors, idx + 1, idx + 2)
            tensors, m_b = self._op_homodyne(tensors, idx + 1, tb * ones, a_zero=(tb == 0.0))
            tensors, m_d = self._op_homodyne(tensors, idx + 1, td * ones, a_zero=(td == 0.0))
        return tensors, _two_mode_syndromes(mb2type, (m_a, m_b, m_c, m_d))

    def _two(self, tensors, idx, mb2type: MB2Type):
        if self.granularity == "op" or self.fused_pair:
            return self._two_ops(tensors, idx, mb2type)
        with span("op:two"):
            return _two_mode_gadget(tensors, idx, mb2type,
                                    self._bell(np.zeros(tensors[0].shape[0]),
                                               tensors[0].dtype),
                                    self.opts, self._generator, self.qs)

    # ------------------------------------------------------------------
    def _batch_max(self, value: int) -> int:
        """The batch maximum of a host rank: over all ranks of a sharded run."""
        return value if self._shard is None else self._shard[0].max_int(value)

    def _bond_ranks(self, tensors) -> np.ndarray:
        """Batch-max measured rank of every bond: one fetch of the chain."""
        self.counts["rank_fetch"] += 1
        with span("op:rank_fetch"):
            ranks = torch.stack([_col_rank(t) for t in tensors[:-1]])
            if self._shard is not None:
                mesh = self._shard[0]
                ranks = mesh.all_reduce(ranks.to(mesh.device), "max")
            return fetch(ranks).numpy()

    @staticmethod
    def _trim_bucket(n: int) -> int:
        """Finer buckets than powers of two: 1, 2, 4, 8, 16, then multiples
        of 16 (a power-of-two jump 33 -> 64 doubles the memory of every
        downstream (chi d)^2 contraction)."""
        if n <= 16:
            return 1 << (max(1, n) - 1).bit_length()
        return ((n + 15) // 16) * 16

    def _slice_bonds(self, tensors, new):
        """Slice every bond to the sizes in ``new``. A sliced tensor is
        copied, so the untrimmed storage is freed."""
        self.counts["trim"] += 1
        out = []
        with span("op:trim"):
            for i, t in enumerate(tensors):
                l = new[i - 1] if i > 0 else t.shape[1]
                r = new[i] if i < len(tensors) - 1 else t.shape[3]
                if (l, r) == (t.shape[1], t.shape[3]):
                    out.append(t)
                else:
                    out.append(t[:, :l, :, :r].clone(memory_format=torch.contiguous_format))
        return out

    def _trim_to(self, tensors, ranks):
        caps = [int(t.shape[-1]) for t in tensors[:-1]]
        new = [min(c, self._trim_bucket(max(1, int(r)))) for r, c in zip(ranks, caps)]
        if new == caps:
            return tensors
        return self._slice_bonds(tensors, new)

    def _trim_tensors(self, tensors):
        """Slice all bonds down to bucketed batch-max measured ranks."""
        if len(tensors) < 2:
            return tensors
        return self._trim_to(tensors, self._bond_ranks(tensors))

    def _trim_with_ranks(self, tensors):
        """Targeted trim from the host-tracked ranks: no fetch (they equal
        what :meth:`_bond_ranks` would measure; see __init__)."""
        if len(tensors) < 2:
            return tensors
        if len(self._ranks) != len(tensors) - 1:
            raise RuntimeError(
                f"rank tracker out of sync: {len(self._ranks)} tracked bonds "
                f"for a {len(tensors)}-tensor chain")
        return self._trim_to(tensors, self._ranks)

    def _bond_rank_single(self, tensors, j) -> int:
        """Batch-max measured rank of bond ``j`` only (reads ONE tensor)."""
        self.counts["rank1_fetch"] += 1
        with span("op:rank1_fetch"):
            return self._batch_max(max(1, int(fetch(_col_rank(tensors[j])))))

    # ------------------------------------------------------------------
    def init_tensors(self, coeffs: np.ndarray, batch: int):
        """Batched initial product state from (N, 2, 2) real logical
        coefficients: (batch, 1, d, 1) tensors in the device's complex
        dtype."""
        with span("init"):
            return product_tensors(self._gkp_basis(), coeffs, self.qs, batch,
                                   complex_dtype(self.device))

    def readout(self, tensors, frames: np.ndarray):
        """Syndrome-corrected logical rho for a batch: (rho_re, rho_im),
        (B, 2^N, 2^N) real tensors on the device.

        The rho is NOT trace-normalised (the reference's convention):
        weight a truncation discarded shows up as a trace deficit and
        counts as infidelity.

        After a data-sharded :meth:`run_circuit`, ``tensors`` is this
        rank's slice and ``frames`` the gathered frames; every rank returns
        the whole batch's densities.
        """
        frames = np.asarray(frames, np.int32)
        with span("readout"):
            if self._shard is None:
                return corrected_density(
                    tensors, to_device(frames, tensors[0].device), self.qs)
            mesh, counts = self._shard
            lo = sum(counts[:mesh.rank])
            hi = lo + counts[mesh.rank]
            if len(frames) != sum(counts) or tensors[0].shape[0] != hi - lo:
                raise ValueError(
                    f"readout after a data-sharded run takes this rank's "
                    f"{hi - lo} trajectories and the {sum(counts)} gathered "
                    f"frames, got {tensors[0].shape[0]} and {len(frames)}")
            rho = corrected_density(
                tensors, to_device(frames[lo:hi], tensors[0].device), self.qs)
            return tuple(mesh.gather_rows(x.to(mesh.device), counts).to(x.device)
                         for x in rho)

    # ------------------------------------------------------------------
    def run_circuit(self, circuit: MBGKPCircuit, coeffs: np.ndarray, batch: int,
                    rng_seed=0, data_sharding=None):
        """Run ``batch`` trajectories of a transpiled circuit. Outcomes and
        sketches are drawn from one host ``torch.Generator`` seeded by
        ``rng_seed``. Returns (tensors [batched], frames (batch, N, 2)
        numpy).

        ``data_sharding``: a 1-D mesh (:func:`..parallel.data_mesh`), on
        every rank of which this is called with the same arguments. Each
        rank runs its contiguous slice of the batch (``batch // D`` rows,
        one more on the first ``batch % D`` ranks) on this engine's device;
        the returned tensors are that slice, the frames are gathered on
        every rank, and each trajectory equals the serial run's.
        """
        with span("run_circuit"):
            N = circuit._N
            self._shard = None
            if data_sharding is None:
                rows, self._generator = batch, as_generator(rng_seed)
            else:
                mesh = data_sharding
                D = mesh.size
                if batch < D:
                    raise ValueError(f"a batch of {batch} over {D} ranks")
                if not isinstance(rng_seed, (int, np.integer)):
                    raise ValueError("a data-sharded run takes an integer rng_seed")
                counts = [batch // D + (r < batch % D) for r in range(D)]
                lo = sum(counts[:mesh.rank])
                rows = counts[mesh.rank]
                self._shard = (mesh, counts)
                self._generator = BatchShard(rng_seed, batch, lo, lo + rows)
            tensors = self.init_tensors(np.asarray(coeffs, np.float32), rows)
            # product initial state: every bond has capacity (and rank) 1
            self._ranks = [1] * (N - 1) if self._tracking_active else None
            try:
                tensors, frame = self._run_layers(circuit, tensors, rows)
            finally:
                self._ranks = None  # circuit-scoped; do not leak across calls
                self._generator = None
            if self._shard is not None:
                mesh, counts = self._shard
                frame = mesh.gather_rows(torch.from_numpy(frame).to(mesh.device),
                                         counts).cpu().numpy()
            return tensors, frame

    def _run_layers(self, circuit, tensors, batch):
        N = circuit._N
        frame = np.zeros((batch, N, 2), dtype=np.int32)
        prev_synd = np.zeros((batch, N, 2), dtype=np.int32)
        ones = np.ones(batch, np.float32)

        for layer in circuit._layers:
            cur_synd = np.zeros((batch, N, 2), dtype=np.int32)
            for gate in layer.gates:
                if isinstance(gate, ClassicalControl):
                    idx = gate.gate.indices[0]
                    cond = prev_synd[:, idx, 0]
                    dg = isinstance(gate.gate, dv_gates.Pdg)
                    p_angle = -ARCTAN2 if dg else ARCTAN2
                    a2 = np.where(cond == 1, p_angle, np.pi / 2).astype(np.float32)
                    frame[:, idx, 1] ^= cond & frame[:, idx, 0]
                    tensors, cur_synd[:, idx, :] = self._single(
                        tensors, idx, a2, 0.0 * ones, a2, 0.0 * ones,
                        a1=0.0, a1_zero=True)
                    if self.adaptive and not self.fused_single:
                        tensors = self._trim_tensors(tensors)
                    continue

                t = type(gate)
                if t in (dv_gates.T, dv_gates.Tdg):
                    idx = gate.indices[0]
                    base = -1.0 if t is dv_gates.Tdg else 1.0
                    sgn = np.where(frame[:, idx, 0] == 1, -base, base).astype(np.float32)
                    tensors, cur_synd[:, idx, :] = self._single(
                        tensors, idx, (np.pi / 2) * ones, 0.0 * ones,
                        sgn * np.pi / 2, sgn * np.pi / 8, a1=0.0, a1_zero=True)
                    if self.adaptive and not self.fused_single:
                        tensors = self._trim_tensors(tensors)
                    continue

                # frame commutation for static Clifford gates
                if t is dv_gates.H:
                    idx = gate.indices[0]
                    frame[:, idx, :] = frame[:, idx, ::-1]
                elif t in (dv_gates.P, dv_gates.Pdg):
                    idx = gate.indices[0]
                    frame[:, idx, 1] ^= frame[:, idx, 0]
                elif t is dv_gates.CZ:
                    i, j = gate.indices
                    zi = frame[:, i, 1] ^ frame[:, j, 0]
                    zj = frame[:, j, 1] ^ frame[:, i, 0]
                    frame[:, i, 1], frame[:, j, 1] = zi, zj
                elif t is dv_gates.SWAP:
                    i, j = gate.indices
                    frame[:, [i, j], :] = frame[:, [j, i], :]

                if t is dv_gates.I:
                    idx = gate.indices[0]
                    tensors, cur_synd[:, idx, :] = self._single(
                        tensors, idx, (np.pi / 2) * ones, 0.0 * ones,
                        (np.pi / 2) * ones, 0.0 * ones, a1=0.0, a1_zero=True)
                elif t is dv_gates.H:
                    idx = gate.indices[0]
                    tensors, cur_synd[:, idx, :] = self._single(
                        tensors, idx, (-np.pi / 4) * ones, (np.pi / 4) * ones,
                        (-np.pi / 4) * ones, 0.0 * ones, a1=np.pi / 4, a1_zero=False)
                elif t in (dv_gates.P, dv_gates.Pdg):
                    idx = gate.indices[0]
                    a2 = (-ARCTAN2 if t is dv_gates.Pdg else ARCTAN2) * ones
                    tensors, cur_synd[:, idx, :] = self._single(
                        tensors, idx, a2, 0.0 * ones, a2, 0.0 * ones,
                        a1=0.0, a1_zero=True)
                elif t in (dv_gates.CZ, dv_gates.SWAP):
                    idx = min(gate.indices)
                    kind = MB2Type.CZ if t is dv_gates.CZ else MB2Type.SWAP
                    tensors, synd = self._two(tensors, idx, kind)
                    cur_synd[:, idx:idx + 2, :] = synd
                else:
                    raise NotImplementedError(f"Gate {gate} not supported in batched mode.")

                # fused single gadgets are shape- and rank-preserving
                two_mode = t in (dv_gates.CZ, dv_gates.SWAP)
                if self.adaptive and (two_mode or not self.fused_single):
                    tensors = (self._trim_with_ranks(tensors)
                               if self._ranks is not None
                               else self._trim_tensors(tensors))

            frame ^= cur_synd
            frame ^= np.asarray([layer.paulis], dtype=np.int32)
            prev_synd = cur_synd

        return tensors, frame
