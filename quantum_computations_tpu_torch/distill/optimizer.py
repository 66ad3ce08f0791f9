"""Dominance-pruned DFS over distillation-stage sequences.

Parity with reference ``fault-tolerant_.../sequence_optimisation.py``:
``DFSArgs`` (:16-80), the 5-D dominance pruner (:82-117 — monotonicity
argument: the distillation rate decreases in each of (p_out, K, -E, M,
M_idle), so any sequence dominated by an explored one can be cut) and the
recursive DFS with candidate elevation, code/grow branching rules and the
never-grow-backwards constraint (:119-268).

The reference's pruner uses librtree; this one is an exact pure-NumPy
dominance scan per code size L (query: any recorded point <= query point in
all 5 dims) — same results, no native dependency.
"""

from __future__ import annotations

import itertools as itt
import logging
from collections import defaultdict

import numpy as np
from mpmath import inf, isinf

from .codes import filtered_codes
from .sequence import ClassicalStage, GrowStage, LogicalDistillationSequence, QuantumStage

logger = logging.getLogger(__name__)


class DFSArgs:
    def __init__(
        self,
        physical_error_rate,
        memory: int,
        target_error,
        target_size: int,
        rel_input_rate,
        *,
        max_seq_len=inf,
        code_sizes: list[int] | None = None,
    ):
        self.p_local = physical_error_rate
        self.max_seq_len = max_seq_len
        self.memory = memory
        self.target_error = target_error
        self.target_size = target_size
        self.input_rate = rel_input_rate  # units of local gate rate

        self.cl_codes = None
        self.q_codes = None
        self.code_sizes = code_sizes

    def shallow_copy(self) -> "DFSArgs":
        copy = DFSArgs(
            self.p_local, self.memory, self.target_error, self.target_size,
            self.input_rate, max_seq_len=self.max_seq_len,
        )
        copy.cl_codes = self.cl_codes
        copy.q_codes = self.q_codes
        copy.code_sizes = self.code_sizes
        return copy

    def init_codes(self, max_rep_code=inf, max_quantum_code=inf) -> None:
        mr = 12 if isinf(max_rep_code) else int(max_rep_code)
        mq = float("inf") if isinf(max_quantum_code) else max_quantum_code
        self.cl_codes, self.q_codes = filtered_codes(mr, mq)

    def init_code_sizes(self, L_init: int):
        code_sizes = self.code_sizes if self.code_sizes is not None else list(range(self.target_size))
        code_sizes = [L for L in code_sizes if L < self.target_size and L > L_init]
        if self.target_size > L_init:
            code_sizes.append(self.target_size)
        self.code_sizes = code_sizes


class CachedPruner:
    """Exact 5-D dominance pruning, one point store per code size L.

    A query point q = (p_out, K, -E, M, M_idle) is pruned iff some recorded
    point r satisfies r <= q elementwise (the recorded rtree boxes of the
    reference are [r, max], so box-intersection == dominance)."""

    GROW = 1024

    def __init__(self):
        self._points: defaultdict[int, np.ndarray] = defaultdict(
            lambda: np.empty((self.GROW, 5))
        )
        self._counts: defaultdict[int, int] = defaultdict(int)

    @property
    def size(self) -> int:
        return sum(self._counts.values())

    @staticmethod
    def _point(sequence: LogicalDistillationSequence) -> np.ndarray:
        return np.array([
            float(sequence.p_out), float(sequence.K), -float(sequence.encoding_rate),
            float(sequence.M), float(sequence.M_idle),
        ])

    def prune(self, sequence: LogicalDistillationSequence) -> bool:
        L = sequence.L
        n = self._counts[L]
        if n == 0:
            return False
        pts = self._points[L][:n]
        return bool(np.any(np.all(pts <= self._point(sequence)[None, :], axis=1)))

    def insert_prune_value(self, sequence: LogicalDistillationSequence) -> None:
        L = sequence.L
        buf = self._points[L]
        n = self._counts[L]
        if n == len(buf):
            buf = np.concatenate([buf, np.empty_like(buf)])
            self._points[L] = buf
        buf[n] = self._point(sequence)
        self._counts[L] = n + 1


def _add_distillation_branches(args, current, best, pruner, print_progress):
    prev_stage = current.stages[-1]
    cl_code_basis = prev_stage.basis if isinstance(prev_stage, ClassicalStage) else None
    for code in itt.chain(args.cl_codes, args.q_codes):
        new = current.shallow_copy()
        new_args = args.shallow_copy()
        if code[3] == "Quantum":
            new.add_stage(QuantumStage(code[:3], new.L, new.p_L, args.p_local))
            new_args.cl_codes = []  # never classical after quantum
        elif code[4] == cl_code_basis:
            continue  # never two consecutive classical codes on the same axis
        else:
            new.add_stage(ClassicalStage(code[:3], code[4], new.L, new.p_L, args.p_local))

        if new.p_out > current.p_out:
            continue  # error got worse
        best = _dfs_recursive(new_args, new, best, pruner, print_progress)
    return best


def _add_growing_branches(args, current, best, pruner, print_progress):
    for i, L in enumerate(reversed(args.code_sizes)):
        new = current.shallow_copy()
        new.add_stage(GrowStage(L, new.L, new.p_L, args.p_local))
        new_args = args.shallow_copy()
        new_args.code_sizes = args.code_sizes[len(args.code_sizes) - i:]  # never shrink
        best = _dfs_recursive(new_args, new, best, pruner, print_progress)
    return best


_prune_counter = itt.count()


def _dfs_recursive(args, current, best, pruner, print_progress=False):
    if pruner.prune(current):
        if print_progress:
            count = next(_prune_counter)
            if count % 10_000 == 0:
                print(f"Pruner \t Size: {pruner.size}. Count: {count}")
        return best

    # Elevate current sequence to a candidate solution (grow to target size).
    test = current.shallow_copy()
    if test.L < args.target_size:
        test.add_stage(GrowStage(args.target_size, test.L, test.p_L, args.p_local))
    test_rate = test.distillation_rate(args.memory, args.input_rate)
    if test_rate == 0.0:
        return best
    if test_rate <= best._distillation_rate:
        return best
    if test.p_out < args.target_error:
        if print_progress:
            print("\nNew best sequence:")
            print(test)
            print(f"Distillation rate: {float(test_rate):.3e}\n")
        test._distillation_rate = test_rate
        return test
    if len(test.stages) >= args.max_seq_len:
        return best

    # Branch: distillation codes (never distil below the encoding error) ...
    if current.p_out > current.p_L:
        best = _add_distillation_branches(args, current, best, pruner, print_progress)
    # ... and grow stages (never twice in a row).
    if not isinstance(current.stages[-1], GrowStage):
        best = _add_growing_branches(args, current, best, pruner, print_progress)

    pruner.insert_prune_value(current)
    return best


def dfs_code_sequence(args: DFSArgs, init: LogicalDistillationSequence,
                      min_rate: float = 0.0, print_progress: bool = False):
    """Best-rate distillation sequence reaching args.target_error within
    args.memory; only sequences beating `min_rate` are considered (warm start)."""
    args.target_size = max(args.target_size, init.L)
    args.init_codes(2)  # classical codes n>2 observed never relevant
    args.init_code_sizes(int(init.L))
    best = LogicalDistillationSequence.__new__(LogicalDistillationSequence)
    best._distillation_rate = min_rate
    pruner = CachedPruner()

    if min_rate == 0.0 and isinf(args.memory) and isinf(args.max_seq_len):
        logger.warning("Sequence optimisation without constraints may never finish!")
    if isinf(args.memory) and len(args.code_sizes) > 0:
        logger.warning(
            "Sequence optimisation without memory constraint and code growing may never finish!"
        )

    global _prune_counter
    _prune_counter = itt.count()
    next(_prune_counter)
    best = _dfs_recursive(args, init, best, pruner, print_progress)
    if len(best.__dict__) > 1:
        if print_progress:
            print("Best sequence:")
            print(best)
            print(f"Distillation rate: {float(best._distillation_rate):.3e}\n")
        return best
    if print_progress:
        print("No valid sequence exists!")
    return None
