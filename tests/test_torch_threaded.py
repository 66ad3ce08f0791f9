"""The threaded engine runners of the port's batched pipelines
(``pipelines/rb_batched`` and ``pipelines/grover_batched`` with
``threads`` > 1, through ``pipelines/common.run_engines``), on the CPU,
where each engine runs in its own Python thread with no CUDA stream.

Mirrors the JAX package's ``tests/test_pipelines.py::
test_rb_batched_threaded_streams`` and ``test_grover_batched_threaded_streams``
(2 engines; grid 128, cap 10 for RB) with the JAX meta's cell keys. The
port's serial runs are held against the JAX engine in
``test_torch_batched_gkp.py`` and ``test_torch_pipelines.py``; here the
threaded rows are held against the port's serial rows: the circuits and
seeds are drawn from one numpy generator under a lock, so every serial
row reappears among the threaded rows, to 1e-12 (the same float64
arithmetic in another thread). A stress test with fake engines, more
threads than cores and a short switch interval checks the shared
counters, and a worker's exception must reach the caller.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.pipelines import grover_batched as tgb, rb_batched as trbb
from quantum_computations_tpu_torch.pipelines.common import run_engines

ROW_TOL = 1e-12
RB = dict(dbs="10.0", depths="2", num_samples=4, batch=2, grid_points=128,
          grid_span=15.0, max_bond_dim=10, rng_seed=2, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread per test process (the tier-1 run puts six
    test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rb_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rb")
    out = {}
    for threads in (1, 2):
        path = root / f"rb{threads}.dat"
        rows = trbb.main(trbb.RBBatchedConfig(**RB, threads=threads, data_file=str(path)))
        meta = json.loads((root / f"rb{threads}.dat.meta.json").read_text())
        out[threads] = (rows, meta)
    return out


def test_threaded_rb_rows_and_meta(rb_runs):
    rows, meta = rb_runs[2]
    assert len(rows) >= 4
    for r in rows:
        assert set(r) == {"db", "depth", "fidelity", "purity", "trace"}
        assert 0.5 < r["trace"] <= 1.05
        assert -0.05 <= r["fidelity"] <= 1.05
    (cell,) = meta
    assert set(cell) == {  # the JAX package's cell keys
        "db", "depth", "samples", "batch", "attempted", "dropped", "drop_rate",
        "seconds", "sec_per_traj", "mean_fidelity", "sem_fidelity", "engine"}
    assert cell["engine"]["threads"] == 2 and rb_runs[1][1][0]["engine"]["threads"] == 1
    assert cell["samples"] == len(rows) and cell["attempted"] == len(rows) + cell["dropped"]
    assert cell["attempted"] % RB["batch"] == 0


def test_serial_rb_rows_appear_among_the_threaded_rows(rb_runs):
    serial, threaded = rb_runs[1][0], rb_runs[2][0]
    keys = ("fidelity", "purity", "trace")
    for row in serial:
        err = min(max(abs(row[k] - t[k]) for k in keys) for t in threaded)
        assert err <= ROW_TOL, (row, err)


def test_threaded_grover_rows_have_unique_provenance(tmp_path):
    path = tmp_path / "g.dat"
    data = tgb.main(tgb.GroverBatchedConfig(
        tagged="0,4", dbs="10.0", trajectories=4, batch=2, grid_points=128,
        grid_span=15.0, max_bond_dim=4, rng_seed=3, data_file=str(path),
        device="cpu", threads=2))
    assert len(data) >= 4
    prov = [(r["rng_seed"], r["rng_lane"]) for r in data]
    assert len(set(prov)) == len(prov)
    assert {s for s, _ in prov} <= {3 + 2 * k for k in range(len(data))}
    assert json.loads(path.read_text()) == json.loads(json.dumps(data, default=float))
    meta = json.loads((tmp_path / "g.dat.meta.json").read_text())
    assert meta[0]["engine"]["threads"] == 2
    assert meta[0]["attempted"] % 2 == 0  # every threaded batch is full
    for r in data:
        rho = np.array(r["rho_real"]) + 1j * np.array(r["rho_imag"])
        assert rho.shape == (8, 8) and 0.5 < np.trace(rho).real <= 1 + 1e-9


def _engine_threads():
    return [t for t in threading.enumerate() if t.name.startswith("engine-")]


class _FakeEngine:
    """Stands in for BatchedGKP: a fixed logical density per trajectory,
    after a short sleep that releases the interpreter lock, as a fetch
    does; counts its batches; raises on ``fail_at`` (its n-th batch)."""

    def __init__(self, fail_at=None):
        self.device = torch.device("cpu")
        self.batches = 0
        self.fail_at = fail_at

    def run_circuit(self, circuit, coeffs, n, rng_seed=0):
        self.batches += 1
        if self.batches == self.fail_at:
            raise FloatingPointError("engine failed")
        threading.Event().wait(1e-4)
        return n, None

    def readout(self, n, frames):
        rho = torch.zeros(n, 4, 4, dtype=torch.float64)
        rho[:, 0, 0] = 1.0
        return rho, torch.zeros_like(rho)


def test_threaded_sampler_counts_every_batch_under_contention():
    """More threads than cores, a 1 us switch interval: the reserved
    attempts, the rows kept and the batches the engines ran agree."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rep in range(3):
            engines = [_FakeEngine() for _ in range(16)]
            stats = {}
            rows = trbb.sample_depth_batched(engines[0], 10.0, 2, 200, 3,
                                             np.random.default_rng(rep), stats,
                                             runners=engines)
            ran = sum(e.batches for e in engines)
            assert stats["attempted"] == 3 * ran == len(rows)
            assert len(rows) >= 200 and stats["dropped"] == 0
            assert len(rows) < 200 + 3 * len(engines)
            assert not _engine_threads()
    finally:
        sys.setswitchinterval(old)


def test_a_worker_exception_reaches_the_caller():
    engines = [_FakeEngine(), _FakeEngine(fail_at=2), _FakeEngine()]
    with pytest.raises(FloatingPointError, match="engine failed"):
        trbb.sample_depth_batched(engines[0], 10.0, 2, 10_000, 2,
                                  np.random.default_rng(0), {}, runners=engines)
    assert not _engine_threads()
    errors = []
    with pytest.raises(ValueError, match="first"):
        run_engines(lambda r: (_ for _ in ()).throw(ValueError("first")),
                    [_FakeEngine()], errors)
    assert len(errors) == 1
