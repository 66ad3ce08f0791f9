"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything that belongs to one configuration, engine, traffic mix, client
kind or metric is found by name: the cell's entry in ``BENCHMARK.json``
names its configuration (whose file the configuration's entry gives) and
its traffic (``port_bench/traffic/<traffic>.json``); the configuration
names its engine module (``port_bench/engines/<engine_module>.py``,
``gkp_batched`` where it names none), which builds the clients' engines,
runs a job, records the window for the check, and checks; the traffic
names its driver (``port_bench/drivers/<driver>.py``), which makes the
jobs and scores their outputs; each metric is read by
``port_bench/metrics/<metric>.py``, or where there is none by the reader of
the name's stem before its first dot (``busy_share.rb`` by
``busy_share.py``); the check's limits of the cell are in
``port_bench/limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
OUT_DIR = BENCH_DIR / "out"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "quantum_computations_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(bench_dir: Path, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if kind == "metrics" and not path.is_file():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, engine,
    traffic, driver, limits and metrics, all found by name under the
    checkout ``root``."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        self.bench_dir = root / "port_bench"
        bench = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = by_name[name]
        self.chips = int(self.entry["chips"])
        config_entry = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(root / config_entry["file"])
        self.engine = load_module(self.bench_dir, "engines",
                                  self.config.get("engine_module", DEFAULT_ENGINE))
        self.traffic = load_json(self.bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.driver = load_module(self.bench_dir, "drivers", self.traffic["driver"])
        limits = self.bench_dir / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.is_file() else None

        def applies(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m) and (m["moves"] in reported or "workloads" in m)]


class Run:
    """What the metric readers read; a reader returns None where its
    source was not taken in this run."""

    setup_s: float = 0.0
    window_s: float = 0.0
    trajectories: int = 0          # completed in the window, failed ones left out
    traced_trajectories: int = 0
    trace: dict | None = None      # trace.summarize of the traced batches
    syncs: dict | None = None      # syncs.count_syncs_by_source over them
    peak_bytes: int = 0


WARM_SEED = 0x5EED
DEFAULT_ENGINE = "gkp_batched"


def seeds(seed: int) -> tuple[np.random.Generator, ...]:
    """(traffic, warm-up, check) generators of a run's seed; the warm-up's
    is the same in every run, so that every run warms the same batches."""
    traffic, check = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(2)
    return (np.random.default_rng(traffic), np.random.default_rng(WARM_SEED),
            np.random.default_rng(check))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def pick(batches, per_client: int, rng: np.random.Generator) -> list[int]:
    """Indices of the window batches to check: ``per_client`` of each
    client's, drawn from the check's generator."""
    chosen = []
    for client in sorted({b.client for b in batches}):
        mine = [i for i, b in enumerate(batches) if b.client == client]
        chosen += rng.choice(mine, size=min(per_client, len(mine)), replace=False).tolist()
    return sorted(chosen)


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and not np.isnan(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             start: float | None = None, config_overrides: dict | None = None) -> dict:
    """One run; returns the result line's object (with ``checks`` last)."""
    import torch

    from port_bench.harness.loop import run_clients

    start = time.perf_counter() if start is None else start
    config = dict(cell.config, **(config_overrides or {}))
    traffic, engine = cell.traffic, cell.engine
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng_traffic, rng_warm, rng_check = seeds(seed)
    clients = int(traffic.get("clients", 1))

    t_engines = time.perf_counter()
    engines = engine.make_engines(config, traffic, device, clients)
    t_warm = time.perf_counter()
    next_job, score = cell.driver.make_client(config, traffic, rng_traffic)
    warm_job, _ = cell.driver.make_client(config, traffic, rng_warm)
    run = Run()
    with engine.recorder() as recorder:
        # warm-up: one batch per client of the cell's own traffic, in turn,
        # from a generator the window does not use
        run_clients(engines, warm_job, score, recorder, run_job=engine.run_job,
                    batches_per_client=1, serial=True)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run.setup_s = t0 - start
        log(f"set-up: {t_engines - start:.3f} s to the engines, {t_warm - t_engines:.3f} s "
            f"making them, {t0 - t_warm:.3f} s warming {clients} batch(es)")
        batches = []
        if trace:
            batches += _traced(cell, engines, next_job, score, recorder, run, cuda)
        batches += run_clients(engines, next_job, score, recorder, run_job=engine.run_job,
                               deadline=t0 + seconds)
        sync()
        t1 = max([b.end for b in batches] + [time.perf_counter()])
    run.window_s = t1 - t0
    run.peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0
    attempted = sum(b.job.batch for b in batches)
    failed = sum(b.failed for b in batches)
    run.trajectories = attempted - failed
    scores = [s for b in batches for s in b.scores]
    log(f"window: {len(batches)} batches, {attempted} trajectories ({failed} failed) in "
        f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s; peak {run.peak_bytes} bytes; "
        f"mean score {np.mean(scores) if scores else float('nan'):.4f}")
    log(engine.describe(engines))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(cell.bench_dir, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # free the program's state before the reference runs
    del engines
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.limits or {}
    if batches and limits:
        chosen = pick(batches, int(traffic.get("check_batches", 1)), rng_check)
        checks = engine.check(batches, chosen, config, traffic, limits, device, log, rng_check)
    else:
        checks = {name: {"value": None, "limit": lim} for name, lim in limits.items()}
    correct = bool(limits) and bool(batches) and passed(checks)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        from port_bench.harness.trace import breakdown
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    return result


def _traced(cell, engines, next_job, score, recorder, run, cuda):
    """The window's first ``trace_batches`` batches per client under the
    profiler (and, with one client, the sync counter)."""
    import torch

    from port_bench.harness.loop import run_clients
    from port_bench.harness.syncs import count_syncs_by_source
    from port_bench.harness.trace import load_events, summarize

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    counting = count_syncs_by_source() if (cuda and len(engines) == 1) else contextlib.nullcontext()
    n = int(cell.traffic.get("trace_batches", 1))
    with torch.profiler.profile(activities=activities) as prof, counting as syncs:
        with torch.profiler.record_function("bench:window"):
            batches = run_clients(engines, next_job, score, recorder,
                                  run_job=cell.engine.run_job, batches_per_client=n)
            if cuda:
                torch.cuda.synchronize()
    run.syncs = syncs
    run.traced_trajectories = sum(b.job.batch for b in batches)
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        run.trace = summarize(load_events(str(path)))
    finally:
        path.unlink()
    return batches
