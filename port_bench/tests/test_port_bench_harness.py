"""CPU tests of the port's benchmark harness: cells found by name, a cell
added as new files, the copied trace arithmetic, the rate over a window
with a stall, the copied circuit draw, each driver at a tiny grid, and a
run without a card."""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.harness.bench import Cell, Run, load_module, run_cell  # noqa: E402
from port_bench.harness.circuits import grover, random_clifford  # noqa: E402
from port_bench.drivers.common import Job  # noqa: E402
from port_bench.harness.loop import run_clients  # noqa: E402
from port_bench.harness.trace import breakdown, summarize  # noqa: E402

TINY = {"grid_points": 96, "grid_span": 12.0, "max_bond_dim": 8}
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_run(cell: Cell, seed: int = 2**33 + 5, seconds: float = 1.0) -> dict:
    cell.traffic = dict(cell.traffic, batch=2)
    return run_cell(cell, seed, seconds, False, device="cpu", config_overrides=TINY)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_parts_are_found_by_name(name):
    cell = Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert callable(cell.driver.make_client)
    assert cell.limits and cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module(cell.bench_dir, "metrics", m["name"]).read)


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A throwaway configuration, traffic mix, metric and limits, added as
    new files and new entries beside a copy of the benchmark, run with no
    file of the copy edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("out", ".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = dict(json.loads((ROOT / "port_bench/configs/gkp_rb_2q.json").read_text()),
                  name="throwaway_rb", **TINY)
    (tmp_path / "port_bench/configs/throwaway_rb.json").write_text(json.dumps(config))
    (tmp_path / "port_bench/traffic/throwaway_d4.json").write_text(json.dumps(
        {"driver": "rb_random", "clients": 1, "depth": 4, "circuit_seed": 3, "db": 8.0,
         "batch": 2, "check_batches": 1}))
    (tmp_path / "port_bench/metrics/batches_seen.py").write_text(
        "def read(run):\n    return run.trajectories / 2\n")
    (tmp_path / "port_bench/limits/throwaway.json").write_text(json.dumps(
        {"rho_max_abs_diff": 1e-9, "frame_bits_differing": 0, "draw_ks": 3.0}))
    bench["configs"].append({"name": "throwaway_rb", "source": "test", "reduced": [],
                             "file": "port_bench/configs/throwaway_rb.json", "why": "test"})
    bench["workloads"].append({"name": "throwaway", "config": "throwaway_rb",
                               "traffic": "throwaway_d4", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result = run_cell(Cell("throwaway", root=tmp_path), 7, 0.5, False, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"batches_seen", "setup_s"}
    assert result["metrics"]["batches_seen"]["value"] == result["attempted"] / 2
    after = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*")
             if p.is_file() and p in before}
    assert after == before


@pytest.mark.parametrize("name", ["busy_share.rb", "busy_share.grover", "peak_gib.rb_c4"])
def test_a_metric_without_a_reader_of_its_own_takes_its_stems(name):
    run = Run()
    run.trace, run.peak_bytes = {"busy_share": 0.5}, 2**31
    value = load_module(ROOT / "port_bench", "metrics", name).read(run)
    assert value == (50.0 if name.startswith("busy") else 2.0)


def test_rb_circuits_follow_the_traffic_not_the_run_seed():
    """Every run takes random_circ's stream of the traffic's circuit seed;
    the run's seed draws the batch seeds."""
    cell = Cell("rb_d8_10db")
    jobs = {}
    for seed in (1, 2):
        next_job, _ = cell.driver.make_client(cell.config, cell.traffic, np.random.default_rng(seed))
        jobs[seed] = [next_job() for _ in range(3)]
    stream = np.random.default_rng(cell.traffic["circuit_seed"])
    for k in range(3):
        assert jobs[1][k].gates == jobs[2][k].gates == random_clifford(2, 8, stream)
    assert [j.seed for j in jobs[1]] != [j.seed for j in jobs[2]]


def _events():
    """A window [0, 100] us, op:bs spans [10, 30] and [50, 60], kernels on
    two streams overlapping in [20, 25], one copy launched outside spans."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench:window", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "op:bs", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "op:bs", "ts": 50, "dur": 10}]
    for corr, launch, ts, dur, cat in ((1, 12, 15, 10, "kernel"), (2, 28, 20, 15, "kernel"),
                                       (3, 55, 72, 8, "kernel"), (4, 85, 90, 5, "gpu_memcpy")):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
                   "args": {"correlation": corr, "stream": 7 + corr % 2}})
    return ev


def test_trace_busy_share_and_attribution():
    s = summarize(_events())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(33e-6)        # [15, 35] + [72, 80] + [90, 95]
    assert s["busy_share"] == pytest.approx(0.33)
    assert s["per_class"]["bs"]["calls"] == 2
    assert s["per_class"]["bs"]["host_ms"] == pytest.approx(0.030)
    assert s["per_class"]["bs"]["device_ms"] == pytest.approx(0.033)   # 10 + 15 + 8 us
    b = breakdown(s)
    assert b["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx({"op:bs": 37e-6, "outside op spans": 30e-6})


class _StallEngine:
    """Stands in for BatchedGKP: a batch takes 20 ms, the second 300 ms."""

    def __init__(self):
        self.calls = 0

    def run_circuit(self, circuit, coeffs, batch, rng_seed=0):
        self.calls += 1
        time.sleep(0.3 if self.calls == 2 else 0.02)
        return [torch.zeros(batch, 1, 4, 1)], np.zeros((batch, 1, 2), np.int32)

    def readout(self, tensors, frames):
        rho = torch.eye(2).expand(tensors[0].shape[0], 2, 2)
        return rho, torch.zeros_like(rho)


class _NoRecorder:
    def start(self):
        return None

    def stop(self):
        pass


def test_rate_is_taken_over_the_whole_window_with_its_stall():
    def next_job():
        return Job([], 1, np.zeros((1, 2, 2), np.float32), 4, 0, None)

    t0 = time.perf_counter()
    batches = run_clients([_StallEngine()], next_job, lambda job, rho: [1.0] * 4, _NoRecorder(),
                          deadline=t0 + 0.5)
    run = Run()
    run.trajectories = sum(b.job.batch for b in batches)
    run.window_s = max(b.end for b in batches) - t0
    rate = load_module(ROOT / "port_bench", "metrics", "rb_traj_per_s").read(run)
    busy_without_stall = sum(b.end - b.start for b in batches if b.end - b.start < 0.2)
    assert rate == pytest.approx(run.trajectories / run.window_s)
    assert run.window_s > 0.3 and rate < run.trajectories / busy_without_stall / 2


def test_the_loop_drives_the_default_engine_without_a_cell():
    """``loop.make_engines(config, db, device, clients)`` and
    ``run_clients`` without ``run_job`` take the default engine module, as
    ``tools/recording_cost.py`` calls them."""
    from port_bench.harness.bench import seeds
    from port_bench.harness.loop import NullRecorder, make_engines

    cell = Cell("rb_d8_10db")
    config, traffic = dict(cell.config, **TINY), dict(cell.traffic, batch=2)
    engines = make_engines(config, float(traffic["db"]), "cpu", 1)
    assert type(engines[0]).__name__ == "BatchedGKP"
    next_job, score = cell.driver.make_client(config, traffic, seeds(7)[0])
    (batch,) = run_clients(engines, next_job, score, NullRecorder(), batches_per_client=1,
                           serial=True)
    assert batch.out.shape == (2, 4, 4) and batch.failed == 0 and len(batch.scores) == 2


@pytest.mark.parametrize("seed", [0, 1, 123, 2**40 + 3])
def test_circuit_draw_matches_the_port(seed):
    from quantum_computations_tpu_torch.pipelines.rb import random_circ
    dv, gkp = random_circ(2, 8, np.random.default_rng(seed))
    assert random_clifford(2, 8, np.random.default_rng(seed)) == [
        (type(g).__name__, tuple(g.indices)) for g in dv]


def test_grover_gates_match_the_port():
    from quantum_computations_tpu_torch.pipelines.grover import grover as port_grover
    circuit, _ = port_grover([0, 4])
    assert grover([0, 4]) == [(type(g).__name__, tuple(g.indices)) for g in circuit]


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_runs_on_the_cpu_at_a_tiny_grid(name):
    result = tiny_run(Cell(name))
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {m["name"] for m in Cell(name).end_to_end} == set(result["metrics"])


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "rb_d8_10db",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_cut_gap_rule_gives_way_when_it_would_leave_out_most():
    from port_bench.engines.gkp.check import CUT_GAP_MIN, combine, readings
    rho = np.zeros((4, 2, 2))
    ref = rho.copy()
    ref[:, 0, 0] = [1e-6, 2e-6, 3e-3, 4e-3]
    pits = np.random.default_rng(0).random((5, 4, 2))
    few = readings(rho, 0, ref, 0, [1, 1, 1, CUT_GAP_MIN / 2], pits)
    most = readings(rho, 0, ref, 0, [1, CUT_GAP_MIN / 2, CUT_GAP_MIN / 3, CUT_GAP_MIN / 4], pits)
    assert combine([few])["rho_max_abs_diff"] == 3e-3
    assert combine([most])["rho_max_abs_diff"] == 4e-3
    assert combine([few, most])["left_out_share"] == 0.5
    assert combine([few, most])["rho_max_abs_diff"] == 3e-3


_SV_ENGINE = '''"""A throwaway engine: FastStatevector on a random circuit per job."""
import types

import numpy as np


def make_engines(config, traffic, device, clients):
    import torch
    return [types.SimpleNamespace(qubits=int(config["qubits"]), device=torch.device(device))
            for _ in range(clients)]


def run_job(engine, job):
    from quantum_computations_tpu_torch.dv import FastStatevector, gates
    sv = FastStatevector(engine.qubits, device=engine.device)
    sv.run_compiled([getattr(gates, name)(*idx) for name, idx in job.gates])
    p = sv.probs().cpu().numpy().astype(np.float64)
    return p, None, int(not np.all(np.isfinite(p)))


def recorder():
    from port_bench.harness.loop import NullRecorder
    return NullRecorder()


_M = {"H": np.array([[1, 1], [1, -1]]) / np.sqrt(2), "X": np.array([[0, 1], [1, 0]]),
      "CX": np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])}


def _reference(gates, n):
    psi = np.zeros([2] * n, complex)
    psi[(0,) * n] = 1
    for name, idx in gates:
        u = _M[name].reshape([2] * (2 * len(idx)))
        axes = list(range(len(idx), 2 * len(idx)))
        psi = np.moveaxis(np.tensordot(u, psi, axes=(axes, list(idx))), range(len(idx)), idx)
    return np.abs(psi.reshape(-1)) ** 2


def check(batches, chosen, config, traffic, limits, device, log, rng):
    worst = max(float(np.max(np.abs(batches[i].out - _reference(batches[i].job.gates,
                                                                int(config["qubits"])))))
                for i in chosen)
    return {"probs_max_abs_diff": {"value": worst, "limit": limits["probs_max_abs_diff"]}}


def describe(engines):
    return f"{len(engines)} state vector(s) of {engines[0].qubits} qubits"
'''

_SV_DRIVER = '''"""Random H, X and adjacent CX circuits of the traffic's length, one a job."""
import types

import numpy as np


def make_client(config, traffic, rng):
    n, length = int(config["qubits"]), int(traffic["gates"])

    def next_job():
        gates = []
        for _ in range(length):
            kind = int(rng.integers(3))
            q = int(rng.integers(n - 1))
            gates.append(("CX", (q, q + 1)) if kind == 2 else ("HX"[kind], (q,)))
        return types.SimpleNamespace(gates=gates, batch=1, seed=int(rng.integers(2**31)))

    def score(job, probs):
        return [float(np.max(probs))]

    return next_job, score
'''


def test_a_state_vector_configuration_added_as_new_files_runs(tmp_path):
    """A configuration that names an engine module of its own (a
    FastStatevector of 4 qubits on the CPU), with its traffic, driver,
    metric and limits, all added as new files beside a copy of the
    benchmark, runs with ``correct`` true and no file of the copy edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("out", ".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {
        "engines/sv_tiny.py": _SV_ENGINE,
        "drivers/sv_random.py": _SV_DRIVER,
        "configs/sv4.json": json.dumps({"name": "sv4", "engine_module": "sv_tiny", "qubits": 4}),
        "traffic/sv4_g12.json": json.dumps({"driver": "sv_random", "gates": 12,
                                            "check_batches": 3}),
        "metrics/circuits_per_s.py": "def read(run):\n    return run.trajectories / run.window_s\n",
        "limits/sv4_g12.json": json.dumps({"probs_max_abs_diff": 1e-5}),
    }
    for name, text in files.items():
        (tmp_path / "port_bench" / name).write_text(text)
    bench["configs"].append({"name": "sv4", "source": "test", "reduced": [],
                             "file": "port_bench/configs/sv4.json", "why": "test"})
    bench["workloads"].append({"name": "sv4_g12", "config": "sv4", "traffic": "sv4_g12",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "circuits_per_s", "unit": "circuits/s",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["sv4_g12"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("sv4_g12", root=tmp_path)
    assert cell.engine.__file__ == str(tmp_path / "port_bench/engines/sv_tiny.py")
    result = run_cell(cell, 2**35 + 9, 0.3, False, device="cpu")
    assert result["correct"] is True
    assert result["attempted"] > 3 and result["failed"] == 0
    assert set(result["metrics"]) == {"circuits_per_s", "setup_s"}
    assert result["checks"]["probs_max_abs_diff"]["value"] < 1e-5
    after = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*")
             if p.is_file() and p in before}
    assert after == before


def test_the_spread_tool_reckons_quartile_spreads():
    """(Q3 - Q1) / median by statistics.quantiles(n=4), and the same
    leaving out the run farthest from the median only where that narrows it."""
    bench_spread = load_module(ROOT / "port_bench", "tools", "bench_spread")
    runs = [1.0, 1.02, 0.98, 1.01, 0.99, 1.6]
    q1, med, q3 = statistics.quantiles(runs, n=4)
    assert bench_spread.spread(runs) == pytest.approx((q3 - q1) / med)
    q1, med, q3 = statistics.quantiles(runs[:5], n=4)
    assert bench_spread.trimmed_spread(runs) == pytest.approx((q3 - q1) / med)
    steady = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    assert bench_spread.trimmed_spread(steady) == 0.0
    summary = bench_spread.summarize(
        [{"set": s, "result": {"metrics": {"m": {"value": v}}}} for s in (1, 2) for v in runs])
    assert summary["m"]["mean_trimmed"] == pytest.approx(bench_spread.trimmed_spread(runs))
    assert summary["m"]["widest"] == pytest.approx(bench_spread.spread(runs))
