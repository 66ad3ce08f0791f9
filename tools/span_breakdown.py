"""Where a benchmark cell's traced batches spend host time and device-idle
time, by the port's recorded spans.

    python3 tools/span_breakdown.py --workload grover_04_12db --seed 3500001701

Runs the cell as ``port_bench/run.py --trace 1`` does (a one-second window
after the traced batches), keeps the port's recording of the traced
batches (``utils.profiling.last_recording``) and the trace's busy
intervals, and prints one JSON object: per label, calls, host ms and self
host ms per traced trajectory, summed over threads; and per label the
device-idle ms per trajectory during which that label was the innermost
open span of the main thread (``idle_self``), or open at any depth
(``idle_within``). With more than one client the idle columns are left
out (the main thread runs no engine). Needs a CUDA device.
"""

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _gaps(busy, t0, t1):
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [(s, f) for s, f in zip(edges[::2], edges[1::2]) if f > s]


class _Idle:
    """Idle us inside [s, f] by a binary search over sorted, disjoint gaps."""

    def __init__(self, gaps):
        self.starts = [s for s, _ in gaps]
        self.ends = [f for _, f in gaps]
        self.before = [0.0]
        for s, f in gaps:
            self.before.append(self.before[-1] + f - s)

    def upto(self, t):
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, s, f):
        return self.upto(f) - self.upto(s)


def idle_by_span(rec, thread, gaps, to_us):
    """(idle_self, idle_within): idle us per label, innermost and any depth."""
    idle = _Idle(gaps)
    inside = {i: idle.within(to_us(sp.start_ns), to_us(sp.end_ns))
              for i, sp in enumerate(rec.spans) if sp.thread == thread}
    within: dict[str, float] = defaultdict(float)
    own: dict[str, float] = defaultdict(float)
    for i, t in inside.items():
        sp = rec.spans[i]
        within[sp.label] += t
        own[sp.label] += t
        if sp.parent is not None:
            own[rec.spans[sp.parent].label] -= t
    return own, within


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)

    import threading

    from port_bench.harness import bench
    from quantum_computations_tpu_torch.utils import profiling

    kept = {}
    traced = bench._traced

    def keep(cell, engines, next_job, score, recorder, run, cuda):
        batches = traced(cell, engines, next_job, score, recorder, run, cuda)
        kept.update(run=run, rec=profiling.last_recording(), clients=len(engines))
        return batches

    bench._traced = keep
    result = bench.run_cell(bench.Cell(args.workload), args.seed, 1.0, True)
    run, rec = kept["run"], kept["rec"]
    n = run.traced_trajectories
    idle = _gaps(run.trace["busy_intervals"], run.trace["t0"], run.trace["t1"])
    rows = {label: {"calls": r["calls"], "host_ms": 1e3 * r["seconds"] / n,
                    "self_host_ms": 1e3 * r["self_seconds"] / n}
            for label, r in rec.table().items()}
    if kept["clients"] == 1:
        own, within = idle_by_span(rec, threading.main_thread().name, idle, profiling.to_trace_us)
        for label, row in rows.items():
            row["idle_self_ms"] = own.get(label, 0.0) / 1e3 / n
            row["idle_within_ms"] = within.get(label, 0.0) / 1e3 / n
    out = {"workload": args.workload, "seed": args.seed, "traced_trajectories": n,
           "correct": result["correct"], "window_s": run.trace["window_s"],
           "busy_s": run.trace["busy_s"], "idle_ms": sum(f - s for s, f in idle) / 1e3 / n,
           "threads": sorted({s.thread for s in rec.spans}), "spans": rows,
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
