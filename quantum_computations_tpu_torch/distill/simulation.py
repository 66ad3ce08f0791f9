"""Discrete-time Monte-Carlo simulation of a distillation pipeline.

Capability parity with reference ``fault-tolerant_.../sequence_simulation.py``
(per-stage process timers + output buffers, quota-based greedy scheduling
under a memory budget, rate estimation) with a different execution design:

- Processes of a stage are aggregated into a **timer histogram** (count of
  processes per remaining-time bucket) instead of one Python list entry per
  process; a tick is a histogram shift plus ONE binomial draw per stage for
  the finishing cohort, so cost per tick is O(stages · depth), independent of
  how many thousand processes are in flight.
- The greedy quota scheduler is a max-heap over quota gaps rather than a
  sorted-list-with-insort: pop the stage with the largest remaining gap,
  start one process if memory/input/buffer constraints allow (re-push with
  the gap decremented), or drop the stage for this tick on first failure —
  an equivalent greedy schedule to the reference's insort loop (tie-breaks
  among equal quota gaps differ: the heap picks the smallest stage index,
  the reference's pop-from-end picks the most recently inserted; admission
  order among tied stages can therefore differ, which only reshuffles RNG
  draws that diverge by design anyway).

Statistical behaviour is equivalent (Bernoulli-per-process == binomial on
the cohort); RNG streams are NOT reference-identical — the framework defines
its own PRNG discipline and validates distributions, not streams.
"""

from __future__ import annotations

import heapq
import logging

import numpy as np
from numpy.random import Generator, default_rng

from .sequence import LogicalDistillationSequence

logger = logging.getLogger(__name__)


class _StageRuntime:
    """One pipeline stage's in-flight processes and output buffer.

    ``timers[j]`` counts processes with ``j`` ticks of work left. A process
    admitted now starts at bucket ``depth`` and finishes (success with
    probability ``1 - p_fail``) on the tick after bucket 0 is reached —
    ``depth + 1`` ticks total, matching the reference's ``t <= 0`` check.
    """

    __slots__ = ("n", "k", "depth", "p_fail", "K_in", "qubit_size",
                 "timers", "buffer")

    def __init__(self, n, k, depth, p_fail, K_in, qubit_size):
        self.n = n
        self.k = k
        self.depth = depth
        self.p_fail = float(p_fail)
        self.K_in = K_in
        self.qubit_size = qubit_size
        self.timers = np.zeros(depth + 1, dtype=np.int64)
        self.buffer = 0.0

    def admit(self, count: int = 1) -> None:
        self.timers[self.depth] += count

    def tick(self, rng: Generator) -> None:
        finishing = int(self.timers[0])
        if finishing:
            self.buffer += rng.binomial(finishing, 1.0 - self.p_fail)
        # shift every cohort one tick closer to completion
        self.timers[:-1] = self.timers[1:]
        self.timers[-1] = 0

    @property
    def in_flight(self) -> int:
        return int(self.timers.sum())

    def memory_usage(self) -> int:
        active = self.in_flight * self.n
        idle = self.buffer * self.k
        return int((active + idle) * self.K_in * self.qubit_size)


class _Source:
    """Pseudo-stage feeding raw inputs at a (fractional) rate per tick."""

    __slots__ = ("buffer",)

    def __init__(self):
        self.buffer = 0.0


class Simulator:
    """Tick-based simulation of a distillation sequence under a memory budget.

    Same constructor/`run` surface as the reference engine so sequence-model
    code can cross-validate analytic rates against simulated ones.
    """

    def __init__(self, space: int, input_rate, dist_seq: LogicalDistillationSequence,
                 rng_seed: int = 42):
        if space < dist_seq.min_memory_req:
            raise ValueError("Insufficient memory for given distillation sequence")

        self.M = space
        self.rng = default_rng(rng_seed)
        # Input rate in units of local_gate_rate.
        self.input_rate = float(
            dist_seq.distillation_rate(space, input_rate) / dist_seq.encoding_rate
        )
        self.K = dist_seq.K
        self.output = 0.0
        self.source = _Source()

        # Steady-state quota N_i and admission memory cost dM_i per stage.
        self.stages: list[_StageRuntime] = []
        self.quotas: list[float] = []
        self.admit_cost: list[int] = []
        survive, K, prev_size = 1.0, 1, 0
        for stage, p_fail in zip(dist_seq.stages, dist_seq.stage_p_fail):
            depth = stage.get_physical_depth()
            self.stages.append(_StageRuntime(
                stage.n, stage.k, depth, p_fail, K, stage.qubit_size))
            self.admit_cost.append(K * stage.n * (stage.qubit_size - prev_size))
            self.quotas.append(self.input_rate * depth * survive / stage.n)
            prev_size = stage.qubit_size
            survive *= float((1 - p_fail) * stage.k / stage.n)
            K *= stage.k

    # -- scheduling ----------------------------------------------------------
    def memory_usage(self) -> int:
        return sum(s.memory_usage() for s in self.stages)

    def _upstream_buffer(self, i: int):
        return self.stages[i - 1] if i > 0 else self.source

    def _downstream_capacity(self, i: int) -> int:
        return self.stages[i + 1].n if i + 1 < len(self.stages) else 1

    def schedule(self) -> None:
        """Admit new processes greedily by largest quota gap.

        Each heap pop considers the stage with the biggest shortfall against
        its steady-state quota; a stage that cannot admit (memory, starved
        input, or full output buffer) is dropped for the rest of this tick.
        """
        heap = [(-(q - s.in_flight), i) for i, (q, s) in
                enumerate(zip(self.quotas, self.stages))]
        heapq.heapify(heap)
        budget = self.M - self.memory_usage()
        while heap:
            neg_gap, i = heapq.heappop(heap)
            stage = self.stages[i]
            upstream = self._upstream_buffer(i)
            if (budget < self.admit_cost[i]
                    or upstream.buffer < stage.n
                    or stage.buffer >= self._downstream_capacity(i)):
                continue
            upstream.buffer -= stage.n
            stage.admit(1)
            budget -= self.admit_cost[i]
            heapq.heappush(heap, (neg_gap + 1, i))

    # -- time evolution ------------------------------------------------------
    def step(self) -> None:
        self.schedule()
        for stage in self.stages:
            stage.tick(self.rng)
        self.source.buffer += self.input_rate
        self.output += self.stages[-1].buffer
        self.stages[-1].buffer = 0.0

    def run(self, steps: int, collect_data: bool = False, printing: bool = False):
        if not collect_data:
            for _ in range(steps):
                self.step()
            return None

        start = self.output
        mem = np.empty(steps)
        for t in range(steps):
            self.step()
            mem[t] = self.memory_usage()
        if mem.max() > self.M:
            raise RuntimeError("Memory budget exceeded during simulation.")
        outputs = (self.output - start) * self.K
        rate = outputs / steps
        if printing:
            overhead = steps * self.input_rate / outputs if outputs > 0 else np.inf
            print("Input per output qubit (Overhead):", overhead)
            print("Output per time step:", rate)
            print("Mean memory consumption:", mem.mean(),
                  "; (max, min) =", (int(mem.max()), int(mem.min())))
        return {"rate": rate, "avg_memory": float(mem.mean()),
                "max_memory": int(mem.max())}

    def estimate_rate(self) -> float:
        """Warm up until 100 outputs, then measure until 1100.

        Inherits the reference's caveat: a pipeline that deadlocks (memory
        too tight to ever finish an output) loops forever.
        """
        logger.warning("Current implementation of `estimate_rate` can get loop-stuck.")
        while self.output < 100:
            self.step()
        start = self.output
        elapsed = 0
        while self.output < 1100:
            self.step()
            elapsed += 1
        return (self.output - start) * self.K / elapsed
