"""The ``qv30_d30`` cell on the CPU at 10 qubits: a sound run is correct,
runs with the timed path broken underneath are not; the slab work helper's
bounds; the readers of the new spans and counters; the benchmark's frozen
reference against the port's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.harness.bench import Cell, Run, load_module, run_cell  # noqa: E402
from port_bench.metrics import slab_work  # noqa: E402
from port_bench.reference import statevector as bench_ref  # noqa: E402
from quantum_computations_tpu_torch.dv import FastStatevector  # noqa: E402
from quantum_computations_tpu_torch.reference import statevector as port_ref  # noqa: E402

SMALL = {"qubits": 10}
PER_LAYER = ["sv_plan_host_ms.qv30", "sv_layout_copies.qv30", "sv_layout_hbm_share.qv30",
             "slab_matmul_roofline.qv30"]


def small_run(seed=2**35 + 77, seconds=0.5):
    return run_cell(Cell("qv30_d30"), seed, seconds, False, device="cpu",
                    config_overrides=SMALL)


def test_the_cell_runs_correct_at_ten_qubits():
    result = small_run()
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0  # a loaded host may fit one
    assert set(result["metrics"]) == {"rb_traj_per_s", "setup_s"}
    limits = json.loads((ROOT / "port_bench/limits/qv30_d30.json").read_text())
    for name, c in result["checks"].items():
        assert c["limit"] == limits[name] and c["value"] <= c["limit"]


def _remap_ignored(monkeypatch):
    """Amplitudes read as if the layout were the identity."""
    def amplitudes(self, indices):
        at = torch.as_tensor(np.asarray(indices, np.int64))
        return torch.complex(self.re[at], self.im[at]).numpy()

    monkeypatch.setattr(FastStatevector, "amplitudes", amplitudes)


def _targets_swapped(monkeypatch):
    """One SU(4) of each circuit applied with its targets swapped."""
    real = FastStatevector.run_compiled

    def run_compiled(self, gates):
        gates = list(gates)
        u, (a, b) = gates[7]
        gates[7] = (u, (b, a))
        return real(self, gates)

    monkeypatch.setattr(FastStatevector, "run_compiled", run_compiled)


def _sample_bits_reversed(monkeypatch):
    real = FastStatevector.sample

    def sample(self, generator, shots=1):
        x = real(self, generator, shots)
        y = np.zeros_like(x)
        for b in range(self.N):
            y |= ((x >> b) & 1) << (self.N - 1 - b)
        return y

    monkeypatch.setattr(FastStatevector, "sample", sample)


@pytest.mark.parametrize("fault,seen_by", [(_remap_ignored, "amp_rel_err"),
                                           (_targets_swapped, "amp_rel_err"),
                                           (_sample_bits_reversed, "xeb_dev")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, seen_by):
    fault(monkeypatch)
    result = small_run()
    assert result["correct"] is False
    assert result["checks"][seen_by]["value"] > result["checks"][seen_by]["limit"]


def test_the_precision_control_fails_the_amplitude_limit():
    """The reference with TF32 inputs to every gate product, read as the
    port's amplitudes, exceeds ``amp_rel_err``'s limit at 10 qubits already."""
    cell = Cell("qv30_d30")
    config = dict(cell.config, **SMALL)
    job = cell.driver.make_client(config, cell.traffic, np.random.default_rng(1))[0]()
    psi = bench_ref.simulate(job.gates, job.N)
    control = bench_ref.simulate(job.gates, job.N, tf32_inputs=True)
    amps = control[torch.from_numpy(job.indices)].numpy()
    err, _ = cell.engine.readings(job, amps, np.zeros(4, np.int64), psi)
    assert err > cell.limits["amp_rel_err"]


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_one_tf32_product_a_window_fails_the_amplitude_limit(rounding):
    """The timed path with every slab window a 1xTF32 product (the
    configuration's FP32-accurate windows one precision lower) exceeds
    ``amp_rel_err``'s limit at 10 qubits already, rounded to nearest or
    truncated, while the same circuit in FP32 windows passes."""
    from port_bench.tools.qv_controls import tf32_windows

    cell = Cell("qv30_d30")
    config = dict(cell.config, **SMALL)
    job = cell.driver.make_client(config, cell.traffic, np.random.default_rng(4))[0]()
    psi = bench_ref.simulate(job.gates, job.N)
    (sv,) = cell.engine.make_engines(config, cell.traffic, "cpu", 1)
    sound = cell.engine.run_job(sv, job)[0]
    with tf32_windows(rounding):
        control = cell.engine.run_job(sv, job)[0]
    limit = cell.limits["amp_rel_err"]
    assert cell.engine.readings(job, sound, np.zeros(4, np.int64), psi)[0] < limit
    assert cell.engine.readings(job, control, np.zeros(4, np.int64), psi)[0] > limit


def test_window_bounds_at_thirty_qubits():
    """N = 30, d = 128: 16 GiB over 3.35 TB/s is 5.13 ms; 2^40 operations
    over 495 TFLOP/s 2.22 ms; the bound is the first."""
    assert slab_work.window_bytes(30, 128) / slab_work.HBM_BYTES_PER_S == \
        pytest.approx(5.128e-3, rel=1e-3)
    assert slab_work.window_flops(30, 128) / slab_work.TF32_FLOP_PER_S == \
        pytest.approx(2.221e-3, rel=1e-3)
    assert slab_work.window_bound_s(30, 128) == pytest.approx(5.128e-3, rel=1e-3)


@pytest.fixture
def traced_run(monkeypatch):
    """Two traced circuits at N = 30: 146 and 150 windows, 1500 and 1400
    plane copies (8 GiB read and written each); 2 s of window device time,
    6 s of layout device time, 0.4 s host in the planner."""
    monkeypatch.setattr(slab_work, "_notes", [])
    for copies in (1500, 1400):
        slab_work.note({"N": 30, "d": 128, "plane_copies": copies,
                        "layout_bytes": copies * 8 * 2**30})
    run = Run()
    run.traced_trajectories = 2
    run.trace = {"per_class": {"sv_window": {"calls": 296, "host_ms": 5.0, "device_ms": 2000.0},
                               "sv_layout": {"calls": 700, "host_ms": 9.0, "device_ms": 6000.0},
                               "sv_plan": {"calls": 2, "host_ms": 400.0, "device_ms": 1.0}}}
    return run


def _read(name, run):
    return load_module(ROOT / "port_bench", "metrics", name).read(run)


def test_readers_of_the_new_spans_and_counters(traced_run):
    assert _read("sv_plan_host_ms.qv30", traced_run) == pytest.approx(200.0)
    assert _read("sv_layout_copies.qv30", traced_run) == pytest.approx(1450.0)
    assert _read("sv_layout_hbm_share.qv30", traced_run) == pytest.approx(
        2900 * 8 * 2**30 / (6.0 * 3.35e12))
    assert _read("slab_matmul_roofline.qv30", traced_run) == pytest.approx(
        100 * 296 * slab_work.window_bound_s(30, 128) / 2.0)


@pytest.mark.parametrize("name", PER_LAYER)
def test_readers_give_nothing_where_nothing_was_traced(name, traced_run, monkeypatch):
    untraced = Run()
    assert _read(name, untraced) is None
    monkeypatch.setattr(slab_work, "_notes", [])
    traced_run.trace = {"per_class": {}}
    assert _read(name, traced_run) is None


def test_the_engine_notes_only_the_jobs_run_under_the_profiler():
    cell = Cell("qv30_d30")
    config = dict(cell.config, **SMALL)
    (sv,) = cell.engine.make_engines(config, cell.traffic, "cpu", 1)
    next_job, _ = cell.driver.make_client(config, cell.traffic, np.random.default_rng(3))
    cell.engine.run_job(sv, next_job())
    assert slab_work.notes(Run()) is None and not slab_work._notes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cell.engine.run_job(sv, next_job())
    (note,) = slab_work._notes
    assert note["N"] == 10 and note["d"] == 128
    assert set(note) == {"N", "d", "plane_copies", "layout_bytes"}
    assert note["plane_copies"] > 0 and note["layout_bytes"] == note["plane_copies"] * 8 * 2**10


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 3])
def test_the_frozen_reference_draws_and_simulates_as_the_ports(seed):
    a = port_ref.quantum_volume(8, 8, np.random.default_rng(seed))
    b = bench_ref.quantum_volume(8, 8, np.random.default_rng(seed))
    assert [t for _, t in a] == [t for _, t in b]
    for (ua, _), (ub, _) in zip(a, b):
        np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(port_ref.simulate(a, 8).numpy(), bench_ref.simulate(b, 8).numpy())


def test_the_traffic_fixes_the_circuits_and_the_seed_draws_the_rest():
    cell = Cell("qv30_d30")
    config = dict(cell.config, **SMALL)
    jobs = [cell.driver.make_client(config, cell.traffic, np.random.default_rng(s))[0]()
            for s in (1, 2)]
    for (ua, ta), (ub, tb) in zip(jobs[0].gates, jobs[1].gates):
        assert ta == tb
        np.testing.assert_array_equal(ua, ub)
    assert jobs[0].seed != jobs[1].seed
    assert not np.array_equal(jobs[0].indices, jobs[1].indices)
    assert len(jobs[0].indices) == cell.traffic["amplitudes"] and jobs[0].shots == 1024


def test_the_cpu_refuses_the_full_width():
    cell = Cell("qv30_d30")
    with pytest.raises(ValueError, match="card"):
        cell.engine.make_engines(cell.config, cell.traffic, "cpu", 1)
