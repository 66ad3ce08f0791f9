"""The plain reference against the port's complex128 path on the CPU, at a
small grid and cap, with the port's draws replayed."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.drivers.common import initial_coeffs, port_circuit  # noqa: E402
from port_bench.harness.circuits import grover, random_clifford  # noqa: E402
from port_bench.engines.gkp.record import DrawRecorder  # noqa: E402
from port_bench.reference.engine import Tape, db2eps, replay_batch, transpile  # noqa: E402


def port_and_reference(gates, N, d, chi, batch, seed, db=10.0):
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    qs = np.linspace(-12, 12, d)
    coeffs = initial_coeffs(["ZERO"] * N)
    engine = BatchedGKP(qs, db2eps(db), {"rel_err": 1e-2, "max_bond_dim": chi},
                        adaptive=True, granularity="op", device="cpu")
    with DrawRecorder() as recorder:
        tape = recorder.start()
        tensors, frames = engine.run_circuit(port_circuit(gates, N), coeffs, batch, rng_seed=seed)
        re, im = (x.numpy() for x in engine.readout(tensors, frames))
        recorder.stop()
    assert tensors[0].dtype.itemsize == 16  # complex128 on the CPU
    indices, sketches = tape.for_reference()
    assert indices and sketches
    rho, ref_frames, cut_gap = replay_batch(gates, N, coeffs, batch, Tape(indices, sketches),
                                            qs=qs, epsilon=db2eps(db), max_bond_dim=chi,
                                            rel_err=1e-2, device="cpu")
    return re + 1j * im, frames, rho, ref_frames, cut_gap, (indices, sketches)


@pytest.mark.parametrize("seed", [3, 11])
def test_reference_replays_rb_batches(seed):
    gates = random_clifford(2, 6, np.random.default_rng(seed))
    rho, frames, ref_rho, ref_frames, cut_gap, _ = port_and_reference(gates, 2, 128, 8, 3, seed)
    assert np.abs(rho - ref_rho).max() < 1e-12
    assert (frames == ref_frames).all()
    assert cut_gap.shape == (3,) and (cut_gap > 0).all()


def test_reference_replays_a_grover_batch():
    rho, frames, ref_rho, ref_frames, _, _ = port_and_reference(grover([0, 4]), 3, 96, 8, 2, 5)
    assert np.abs(rho - ref_rho).max() < 1e-12
    assert (frames == ref_frames).all()


def test_reference_follows_the_draws_it_is_handed():
    gates = random_clifford(2, 6, np.random.default_rng(4))
    rho, _, ref_rho, _, _, (indices, sketches) = port_and_reference(gates, 2, 128, 8, 2, 9)
    moved = [i.copy() for i in indices]
    moved[2][0] += 1
    N, coeffs, qs = 2, initial_coeffs(["ZERO"] * 2), np.linspace(-12, 12, 128)
    other, _, _ = replay_batch(gates, N, coeffs, 2, Tape(moved, sketches), qs=qs,
                               epsilon=db2eps(10.0), max_bond_dim=8, rel_err=1e-2,
                               device="cpu")
    assert np.abs(other - rho).max() > 1e-6
    with pytest.raises(StopIteration):
        replay_batch(gates, N, coeffs, 2, Tape(indices[:-1], sketches), qs=qs,
                     epsilon=db2eps(10.0), max_bond_dim=8, rel_err=1e-2, device="cpu")


def test_transpile_matches_the_port():
    from quantum_computations_tpu_torch.gkp import MBGKPCircuit
    for gates, N in ((grover([2, 7]), 3), (random_clifford(2, 10, np.random.default_rng(1)), 2)):
        port = port_circuit(gates, N)
        ours = transpile(gates, N)
        assert isinstance(port, MBGKPCircuit) and len(ours) == port.depth()
        for mine, theirs in zip(ours, port._layers):
            names = [("c" + type(g.gate).__name__) if hasattr(g, "gate") else type(g).__name__
                     for g in theirs.gates]
            assert [n for n, _ in mine.gates] == names
            assert [i for _, i in mine.gates] == [tuple(g.indices) for g in theirs.gates]
            assert mine.paulis == theirs.paulis


def test_the_draws_transform_to_uniform_under_the_reference():
    """The port's draws, judged under the reference's distributions, give
    uniform transforms; moved by a grid point they do not."""
    from port_bench.engines.gkp.check import draw_ks
    gates = random_clifford(2, 8, np.random.default_rng(6))
    *_, (indices, sketches) = port_and_reference(gates, 2, 128, 8, 24, 21)
    N, coeffs, qs = 2, initial_coeffs(["ZERO"] * 2), np.linspace(-12, 12, 128)
    readings = []
    for shift in (0, 1):
        tape = Tape([np.minimum(i + shift, 127) for i in indices], sketches,
                    np.random.default_rng(0))
        replay_batch(gates, N, coeffs, 24, tape, qs=qs, epsilon=db2eps(10.0), max_bond_dim=8,
                     rel_err=1e-2, device="cpu")
        pits = np.stack(tape.pits)
        assert pits.shape == (len(indices), 24, 2) and ((pits >= 0) & (pits <= 1)).all()
        readings.append(draw_ks(pits.reshape(-1, 2)))
    assert readings[0] < 2.0 < 3.0 < readings[1], readings


def test_ks_reads_a_uniform_sample_low_and_a_skewed_one_high():
    from port_bench.engines.gkp.check import ks_sqrt_n
    u = np.random.default_rng(1).random(4000)
    assert ks_sqrt_n(u) < 2.0 and ks_sqrt_n(u ** 1.3) > 5.0
    assert ks_sqrt_n(np.arange(1, 101) / 101) < 0.1
