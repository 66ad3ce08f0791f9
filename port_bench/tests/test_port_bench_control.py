"""On the card: the control (the reference in complex64 with TF32 products)
fails the cell's density limit where the timed path passes it, at the
cell's own grid and cap and a batch of 2. Run on the card with
``python -m pytest -m cuda port_bench/tests/test_port_bench_control.py``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rb_d8_10db", "grover_04_12db"])
def test_control_fails_where_the_timed_path_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from port_bench.engines.gkp import check
    from port_bench.harness.bench import Cell, seeds
    from port_bench.harness.loop import run_clients

    cell = Cell(name)
    traffic = dict(cell.traffic, batch=2)
    db = float(traffic["db"])
    limit = cell.limits["rho_max_abs_diff"]
    (engine,) = cell.engine.make_engines(cell.config, traffic, "cuda", 1)
    next_job, score = cell.driver.make_client(cell.config, traffic, seeds(17)[0])
    with cell.engine.recorder() as recorder:
        (batch,) = run_clients([engine], next_job, score, recorder, run_job=cell.engine.run_job,
                               batches_per_client=1)
    rho, frames, gap, pits = check.reference_of(batch, cell.config, db, "cuda")
    c_rho, c_frames, _, _ = check.reference_of(batch, cell.config, db, "cuda",
                                               dtype=torch.complex64, tf32=True)
    sound = check.readings(batch.out, batch.aux, rho, frames, gap, pits)
    control = check.readings(c_rho, c_frames, rho, frames, gap, pits)
    assert sound["rho_max_abs_diff"] <= limit < control["rho_max_abs_diff"], (sound, control)
    assert sound["frame_bits_differing"] == 0
