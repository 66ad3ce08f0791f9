"""A run on the CPU at a tiny grid, with the timed path broken underneath,
comes out not correct; the same run unbroken comes out correct."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.harness.bench import Cell, run_cell  # noqa: E402

TINY = {"grid_points": 96, "grid_span": 12.0, "max_bond_dim": 8}


def tiny_run(name="rb_d8_10db"):
    cell = Cell(name)
    cell.traffic = dict(cell.traffic, batch=4)
    return run_cell(cell, 2**34 + 1, 0.5, False, device="cpu", config_overrides=TINY)


def test_unbroken_run_is_correct():
    assert tiny_run()["correct"] is True


def test_a_moved_draw_is_seen_by_the_draws_test_alone(monkeypatch):
    _draw_moved(monkeypatch)
    checks = tiny_run()["checks"]
    assert checks["draw_ks"]["value"] > checks["draw_ks"]["limit"]
    assert checks["rho_max_abs_diff"]["value"] <= checks["rho_max_abs_diff"]["limit"]
    assert checks["frame_bits_differing"]["value"] == 0


def _state_unchanged(monkeypatch):
    """Each single gadget draws as before but returns its input state."""
    from quantum_computations_tpu_torch.gkp import batched
    real = batched.fused_single_gadget

    def unchanged(tensors, *args, **kwargs):
        _, m1, m2 = real(tensors, *args, **kwargs)
        return list(tensors), m1, m2

    monkeypatch.setattr(batched, "fused_single_gadget", unchanged)


def _readout(monkeypatch, alter):
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    real = BatchedGKP.readout
    monkeypatch.setattr(BatchedGKP, "readout",
                        lambda self, tensors, frames: alter(*real(self, tensors, frames)))


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean of the rest in its place."""
    def alter(re, im):
        h = re.shape[0] // 2
        return (torch.cat([re[:h], re[:h].mean(0, keepdim=True).expand(re.shape[0] - h, -1, -1)]),
                torch.cat([im[:h], im[:h].mean(0, keepdim=True).expand(im.shape[0] - h, -1, -1)]))
    _readout(monkeypatch, alter)


def _density_altered(monkeypatch):
    def alter(re, im):
        re = re.clone()
        re[0, 0, 0] += 1e-3
        return re, im
    _readout(monkeypatch, alter)


def _frame_altered(monkeypatch):
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    real = BatchedGKP.run_circuit

    def run_circuit(self, *args, **kwargs):
        tensors, frames = real(self, *args, **kwargs)
        frames = np.array(frames)
        frames[0, 0, 0] ^= 1
        return tensors, frames

    monkeypatch.setattr(BatchedGKP, "run_circuit", run_circuit)


def _draw_moved(monkeypatch):
    """Every homodyne outcome moved by two grid points where it is drawn:
    the state follows it, so only the draws' test can see it."""
    from quantum_computations_tpu_torch.ops import fused_gadget
    real = fused_gadget._draw

    def moved(dist, forced, generator):
        return (real(dist, forced, generator) + 2).clamp(0, dist.shape[1] - 1)

    monkeypatch.setattr(fused_gadget, "_draw", moved)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _density_altered,
                                   _frame_altered, _draw_moved])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert tiny_run()["correct"] is False
