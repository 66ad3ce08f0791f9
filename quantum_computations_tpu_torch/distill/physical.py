"""Physical (pre-encoding) Bell-pair distillation.

Capability parity with reference ``fault-tolerant_.../physical_distillation.py``
(idling-aware sequence evaluation with bisection-constrained input rate
:14-98, the DFS search variant :104-204, the rate-table extrapolator
:207-236 and the table generator :239-323), restructured:

- The per-stage evaluation loop lives in one free function
  :func:`evaluate_pipeline`; both the unconstrained and constrained entry
  points (and the table generator) go through it.
- The branch-and-bound search is an **explicit-stack DFS**
  (:func:`dfs_code_sequence`) rather than recursion — identical preorder
  traversal, prune tests and best-so-far threading, without Python's
  recursion limit in the loop.
- The step-table extrapolator resolves lookups with ``numpy.searchsorted``.

All error/rate arithmetic stays mpf-exact (process-wide dps=80, see
``hardware.py``).
"""

from __future__ import annotations

import json
import logging
from itertools import chain
from typing import NamedTuple

import numpy as np
from mpmath import isinf, mpf

from .hardware import DepolarisationChannel, find_root_bisection
from .optimizer import DFSArgs
from .sequence import ClassicalStage, InitStage, QuantumStage, Stage, scalar_error

logger = logging.getLogger(__name__)


class PipelineEval(NamedTuple):
    """Figures of merit of one idling-aware pipeline evaluation."""

    p_out: object   # scalar output error (mpf)
    memory: object  # steady-state memory demand (mpf)
    rate: object    # encoding rate E (mpf)


def evaluate_pipeline(stages: list[Stage], input_rate, *,
                      idling: DepolarisationChannel | None = None,
                      local_gate_rate: float = 1.0) -> PipelineEval:
    """Steady-state figures of merit of a physical-distillation pipeline fed
    at ``input_rate``: inputs to stage i arrive at rate ``r E / (n K)``, so
    each waits ``1/r_in`` accruing idling noise before being consumed
    (reference physical_distillation.py:66-90)."""
    memory, K, E = 0, 1, 1
    p_out = stages[0].error
    for stage in stages[1:]:
        wait = stage.n * K / (input_rate * E)
        p_in = idling.apply(p_out, wait) if idling else p_out
        p_out, p_fail = stage.compute_error_metrics(p_in)
        depth = stage.get_physical_depth() / local_gate_rate
        memory += stage.qubit_size * K * (depth * E * input_rate + (stage.n - 1) / 2)
        E *= (1 - p_fail) * stage.k / stage.n
        K *= stage.k
    return PipelineEval(scalar_error(p_out), memory, E)


class PhysicalDistillationSequence:
    """Distillation of physical Bell pairs (no surface-code encoding; idling
    noise accrues while stages wait for inputs). Serialisation format shared
    with :class:`..sequence.LogicalDistillationSequence` stages."""

    def __init__(self, init_stage: InitStage):
        self.stages: list[Stage] = [init_stage]
        self.min_memory_req: int = 0
        self.K = 1

    def __str__(self):
        lines = ["Distillation stages:"]
        lines += [f"{str(s):<15}: L={s.L}, p_L={float(s.p_L):.3e},"
                  for s in self.stages]
        lines.append(f"Summary: memory requirement={self.min_memory_req},")
        return "\n".join(lines)

    # -- (de)serialisation ----------------------------------------------------
    def serialise(self) -> str:
        return json.dumps([stage.serialise() for stage in self.stages])

    @staticmethod
    def deserialise(data_str: str) -> "PhysicalDistillationSequence":
        stages = [Stage.from_serialised(s) for s in json.loads(data_str)]
        seq = PhysicalDistillationSequence(stages[0])
        for stage in stages[1:]:
            seq.add_stage(stage)
        return seq

    # -- construction ----------------------------------------------------------
    def add_stage(self, stage: Stage):
        grow = (stage.qubit_size - self.stages[-1].qubit_size) * stage.n * self.K
        floor = stage.n * self.K * stage.qubit_size
        carry = (stage.n - 1) * self.K * stage.qubit_size + self.min_memory_req + grow
        self.stages.append(stage)
        self.min_memory_req = max(floor, carry)
        self.K *= stage.k

    def shallow_copy(self) -> "PhysicalDistillationSequence":
        copy = PhysicalDistillationSequence.__new__(PhysicalDistillationSequence)
        copy.stages = self.stages.copy()
        copy.min_memory_req = self.min_memory_req
        copy.K = self.K
        return copy

    # -- evaluation --------------------------------------------------------------
    def eval_non_constrained_sequence(self, input_rate, *,
                                      idleing: DepolarisationChannel | None = None,
                                      local_gate_rate: float = 1.0):
        """(scalar output error, memory demand, encoding rate) at a given
        unconstrained input rate."""
        return tuple(evaluate_pipeline(self.stages, input_rate, idling=idleing,
                                       local_gate_rate=local_gate_rate))

    def eval_constrained_sequence(self, max_input_rate, allocated_memory, *,
                                  idleing: DepolarisationChannel | None = None,
                                  local_gate_rate: float = 1.0):
        """(input rate, output error, encoding rate) with the input rate
        bisected down until the memory demand fits ``allocated_memory``."""
        if self.min_memory_req > allocated_memory:
            raise ValueError(
                "Sequence cannot be evaluated with less than minimum memory requirement."
            )

        def at(rate):
            return evaluate_pipeline(self.stages, rate, idling=idleing,
                                     local_gate_rate=local_gate_rate)

        full = at(max_input_rate)
        if full.memory <= allocated_memory:
            return max_input_rate, full.p_out, full.rate
        rate = find_root_bisection(
            lambda r: allocated_memory - at(r).memory,
            mpf("1e-6"), min(mpf("1e10"), max_input_rate))
        fit = at(rate)
        return rate, fit.p_out, fit.rate


# ---------------------------------------------------------------------------
# branch-and-bound search (explicit-stack DFS)
# ---------------------------------------------------------------------------

def _expand(node: PhysicalDistillationSequence, args: DFSArgs,
            idleing: DepolarisationChannel):
    """Children of a search node: one new stage per candidate code, each
    evaluated under the memory constraint. Quantum stages disable further
    classical codes; consecutive same-basis classical stages are skipped
    (reference physical_distillation.py:134-160)."""
    last = node.stages[-1]
    last_basis = last.basis if isinstance(last, ClassicalStage) else None
    children = []
    for code in chain(args.cl_codes, args.q_codes):
        child = node.shallow_copy()
        child_args = args.shallow_copy()
        if code[3] == "Quantum":
            child.add_stage(QuantumStage(code[:3], 1, args.p_local, args.p_local))
            child_args.cl_codes = []
        elif code[4] == last_basis:
            continue
        else:
            child.add_stage(ClassicalStage(code[:3], code[4], 1,
                                           args.p_local, args.p_local))
        try:
            in_rate, p_out, E = child.eval_constrained_sequence(
                args.input_rate, args.memory, idleing=idleing)
        except Exception:
            logger.warning(
                f"Error while evaluating sequence:\n{child}\nSkipping this branch")
            continue
        child._distillation_rate = in_rate * E
        child.p_out = p_out
        if child.p_out <= node.p_out:  # monotone-improvement requirement
            children.append((child_args, child))
    return children


def dfs_code_sequence(args: DFSArgs, init: PhysicalDistillationSequence,
                      min_rate: float = 0.0, print_progress: bool = False):
    """Best physical-distillation sequence above ``min_rate`` meeting
    ``args.target_error`` within ``args.memory``."""
    args.init_codes(6, 6)
    # Idling channel numerics from the reference driver
    # (physical_distillation.py:171-173): per-gate idle Pauli rates, 200
    # idle errors per physical gate time.
    idleing = DepolarisationChannel(np.array([5e-6 / 25, 5e-6 / 25, 2e-5 / 25]), 200)

    in_rate, p_out, E = init.eval_constrained_sequence(
        args.input_rate, args.memory, idleing=idleing)
    init._distillation_rate = in_rate * E
    init.p_out = p_out

    if min_rate == 0.0 and isinf(args.memory) and isinf(args.max_seq_len):
        logger.warning("Sequence optimisation without constraints may never finish!")

    best, best_rate = None, min_rate
    stack = [(args, init)]
    while stack:
        node_args, node = stack.pop()
        if node.min_memory_req > node_args.memory:
            continue
        rate = node._distillation_rate
        if rate == 0.0 or rate <= best_rate:
            continue
        if node.p_out < node_args.target_error:
            best, best_rate = node, rate
            if print_progress:
                print(f"\nNew best sequence:\n{node}\n"
                      f"Distillation rate: {float(rate):.3e}\n")
            continue
        if len(node.stages) >= node_args.max_seq_len:
            continue
        # push in reverse so the first candidate code is explored first
        stack.extend(reversed(_expand(node, node_args, idleing)))
    return best


# ---------------------------------------------------------------------------
# rate table: extrapolator + generator
# ---------------------------------------------------------------------------

class PhysicalDistillationRateExtrapolator:
    """Step-wise lookup over a precomputed (rate, memory) -> rate table
    (reference physical_distillation.py:207-236)."""

    def __init__(self, filepath: str, *, max_mem: int | None = None):
        with open(filepath) as fh:
            table = json.load(fh)
        xs = [mpf(x) for x in table["xs"]]
        ys = [int(y) for y in table["ys"]]
        zs = [mpf(z) for z in table["zs"]]
        if max_mem is not None:
            cut = int(np.searchsorted(ys, max_mem, side="right")) + 1
            xs, ys, zs = xs[:cut], ys[:cut], zs[:cut]
        self.xs, self.ys, self.zs = xs, ys, zs

    def eval(self, r, M):
        """Achievable first-stage output rate at raw rate ``r`` and memory
        ``M``: memory-limited when ``r`` saturates the table row, rate-limited
        otherwise."""
        if M > self.ys[-1]:
            raise ValueError("Insufficient data for extrapolation.")
        by_mem = max(int(np.searchsorted(self.ys, M, side="right")) - 1, 0)
        if r >= self.xs[by_mem]:
            return self.zs[by_mem]
        by_rate = int(np.searchsorted(self.xs, r, side="right")) - 1
        return self.zs[by_rate]


def generate_rate_table(
    data_file: str,
    *,
    in_error=mpf("5e-2"),
    targ_error=mpf("1e-2"),
    local_error=mpf("1e-3"),
    n_stages: int = 2,
    max_memory: int = 100_000,
    progress: bool = True,
):
    """Generate the physical-distillation rate table (reference __main__,
    physical_distillation.py:239-323): alternating X/Y [2,1,2] repetition
    stages, constrained evaluation per memory point."""
    idling = DepolarisationChannel(mpf("1e-6"))

    seq = PhysicalDistillationSequence(
        InitStage(in_error, 1, local_error, local_error))
    for i in range(n_stages):
        seq.add_stage(ClassicalStage((2, 1, 2), ("X", "Y")[i % 2], 1,
                                     local_error, local_error))

    memories = np.arange(0, max_memory, 1)
    iterator = memories
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(memories)
        except ImportError:
            pass

    xs, zs = [], []
    for M in iterator:
        if M < seq.min_memory_req:
            rate, p, E = 0, 1, 0
        else:
            rate, p, E = seq.eval_constrained_sequence(1e6, M, idleing=idling)
        if p > targ_error:
            xs.append(str(mpf("0")))
            zs.append(str(mpf("0")))
        else:
            xs.append(str(rate))
            zs.append(str(rate * E))

    data = {"xs": xs, "ys": memories.tolist(), "zs": zs}
    with open(data_file, "w") as fh:
        json.dump(data, fh)
    return data
