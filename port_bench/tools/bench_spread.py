"""Run one cell K times, each in a fresh process, and say how its runs
spread and where each run's time went.

    python3 port_bench/tools/bench_spread.py --workload <name> --seeds 11,12,13,14,15,16 \
        [--sets 2] [--seconds <run_seconds>] [--first-seconds 5] [--rows 0] [--out DIR]

from the root of a checkout (a ``git archive`` of a tree will do). Each run
is ``python3 port_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace 0``; ``--sets 2`` runs the seeds twice, one set after the other.
``--first-seconds`` runs one short run first, reported apart: the first run
in a checkout builds the kernels. ``--rows 0`` (the default) runs
``run.py`` itself, as the check does. With ``--rows 1`` each run goes
through this file instead, which imports ``run.py``, wraps
``loop.run_clients`` and the job stream with clock reads and no other
work, and writes one row per batch: its phase (warm, traced, window),
client, position in its job stream, batch seed, start and wall time, and,
where the job carries DV gates, its gate and two-qubit gate counts. For
the GKP engine (``BatchedGKP``) a row also gives the largest (a, b) of its
splits and the host seconds in ``run_circuit`` and in ``readout``.

Writes ``<out>/<workload>.runs.jsonl`` (each run's result line, seed and
set), ``<out>/<workload>.rows.jsonl`` (the batch rows) and prints, per set
and metric, the median and two spreads: (Q3 - Q1) / median by
``statistics.quantiles(n=4)`` over all runs, and the same leaving out the
run farthest from the median where that narrows it.
Imports nothing of JAX or of the port in the process that drives the runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TWO_QUBIT = ("CZ", "SWAP", "CX")


def spread(values: list[float]) -> float | None:
    """(Q3 - Q1) / median of ``values``."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def trimmed_spread(values: list[float]) -> float | None:
    """:func:`spread`, leaving out the value farthest from the median where
    that narrows it."""
    whole = spread(values)
    if len(values) < 4 or whole is None:
        return whole
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(whole, spread(values[:far] + values[far + 1:]))


def summarize(runs: list[dict]) -> dict:
    """{metric: {set: {values, median, spread, trimmed}}, "mean_trimmed", "widest"}."""
    out: dict = {}
    for run in runs:
        for name, m in (run["result"] or {}).get("metrics", {}).items():
            out.setdefault(name, {}).setdefault(str(run["set"]), {"values": []})["values"].append(
                m["value"])
    for name, sets in out.items():
        for s in sets.values():
            s.update(median=statistics.median(s["values"]), spread=spread(s["values"]),
                     trimmed=trimmed_spread(s["values"]))
        trimmed = [s["trimmed"] for s in sets.values() if s["trimmed"] is not None]
        whole = [s["spread"] for s in sets.values() if s["spread"] is not None]
        sets["mean_trimmed"] = sum(trimmed) / len(trimmed) if trimmed else None
        sets["widest"] = max(whole) if whole else None
    return out


# -- one run, instrumented ---------------------------------------------------------


def instrument():
    """Wrap ``loop.run_clients`` (and, where the port has it,
    ``BatchedGKP``'s ``run_circuit`` and ``readout``) with clock reads;
    returns a function that gives the batch rows of every ``run_clients``
    call since."""
    import threading

    from port_bench.harness import loop

    local = threading.local()
    timing: dict[int, dict] = {}
    calls: list[tuple[str, list]] = []
    positions: dict[int, int] = {}
    counters: dict[int, int] = {}

    try:
        from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    except ImportError:
        BatchedGKP = None
    if BatchedGKP is not None:
        real_run, real_readout = BatchedGKP.run_circuit, BatchedGKP.readout

        def run_circuit(self, *a, **kw):
            kept, self.largest = self.largest, {}
            t = time.perf_counter()
            try:
                return real_run(self, *a, **kw)
            finally:
                row = timing.setdefault(getattr(local, "job", None), {})
                row["run_circuit_s"] = time.perf_counter() - t
                row["largest"] = {k: list(v) for k, v in self.largest.items()}
                for k, v in kept.items():
                    if k not in self.largest or v[0] * v[1] > self.largest[k][0] * self.largest[k][1]:
                        self.largest[k] = v

        def readout(self, *a, **kw):
            t = time.perf_counter()
            try:
                return real_readout(self, *a, **kw)
            finally:
                timing.setdefault(getattr(local, "job", None), {})["readout_s"] = (
                    time.perf_counter() - t)

        BatchedGKP.run_circuit, BatchedGKP.readout = run_circuit, readout

    real_clients = loop.run_clients

    def run_clients(engines, next_job, score, recorder, **kw):
        phase = ("warm" if kw.get("serial") else "window" if kw.get("deadline") is not None
                 else "traced")
        key = id(next_job)

        def counted():
            job = next_job()
            positions[id(job)] = counters.get(key, 0)
            counters[key] = counters.get(key, 0) + 1
            local.job = id(job)
            return job

        done = real_clients(engines, counted, score, recorder, **kw)
        calls.append((phase, done))
        return done

    loop.run_clients = run_clients

    def rows() -> list[dict]:
        t0 = min((b.start for phase, done in calls if phase != "warm" for b in done),
                 default=0.0)
        out = []
        for phase, done in calls:
            for b in done:
                gates = getattr(b.job, "gates", None) or []
                row = {"phase": phase, "client": b.client, "pos": positions.get(id(b.job)),
                       "twoq": sum(1 for g in gates if g[0] in TWO_QUBIT),
                       "gates": len(gates), "seed": getattr(b.job, "seed", None),
                       "start_s": b.start - t0, "wall_s": b.end - b.start, "failed": b.failed}
                row.update(timing.get(id(b.job), {}))
                out.append(row)
        return out

    return rows


def _instrumented_run(args) -> int:
    """``port_bench/run.py``'s ``main`` under :func:`instrument`; the batch
    rows go to ``args.rows_file``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_bench_run", ROOT / "port_bench" / "run.py")
    run_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_py)          # sets run.py's START, as a run does
    rows = instrument()
    rc = run_py.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", str(args.trace)])
    with open(args.rows_file, "w") as fh:
        for row in rows():
            fh.write(json.dumps(row) + "\n")
    return rc


# -- the runs ------------------------------------------------------------------------


def _one(args, seed: int, seconds: float, rows_file: Path | None) -> dict:
    if rows_file is None:
        cmd = [sys.executable, "port_bench/run.py"]
    else:
        cmd = [sys.executable, str(Path(__file__).relative_to(ROOT)), "--child",
               "--rows-file", str(rows_file)]
    cmd += ["--workload", args.workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(args.trace)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "process_s": time.perf_counter() - t,
            "result": result, "stderr_tail": proc.stderr[-1500:] if result is None else
            "\n".join(proc.stderr.strip().splitlines()[-8:])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--seconds", type=float)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--first-seconds", type=float, default=0.0)
    parser.add_argument("--rows", type=int, default=0)
    parser.add_argument("--out", default=str(ROOT / "port_bench" / "out" / "spread"))
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--rows-file")
    args = parser.parse_args(argv)
    if args.child:
        sys.path.insert(0, str(ROOT))
        return _instrumented_run(args)

    if args.seconds is None:
        args.seconds = float(json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    runs_path, rows_path = out / f"{args.workload}.runs.jsonl", out / f"{args.workload}.rows.jsonl"
    runs = []
    plan = ([("first", seeds[0] ^ 0x5A5A5A5A, args.first_seconds)] if args.first_seconds else [])
    plan += [(s + 1, seed, args.seconds) for s in range(args.sets) for seed in seeds]
    for set_, seed, seconds in plan:
        rows_file = out / f".rows_{os.getpid()}.jsonl" if args.rows else None
        run = dict(_one(args, seed, seconds, rows_file), set=set_, workload=args.workload)
        with open(runs_path, "a") as fh:
            fh.write(json.dumps(run) + "\n")
        if rows_file is not None and rows_file.is_file():
            with open(rows_path, "a") as fh:
                for line in rows_file.read_text().splitlines():
                    fh.write(json.dumps(dict(json.loads(line), run_seed=seed, set=set_)) + "\n")
            rows_file.unlink()
        r = run["result"] or {}
        print(json.dumps({"set": set_, "seed": seed, "rc": run["rc"],
                          "correct": r.get("correct"), "attempted": r.get("attempted"),
                          "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
                          "process_s": round(run["process_s"], 2)}), flush=True)
        if run["result"] is None:
            print(run["stderr_tail"], file=sys.stderr, flush=True)
        if set_ != "first":
            runs.append(run)
    print(json.dumps({"workload": args.workload, "summary": summarize(runs)}), flush=True)
    return 0 if all(r["result"] and r["result"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
