"""The port's copy of the host-side distillation package
(``quantum_computations_tpu_torch.distill``) and ``utils/colour`` against
the JAX package's: the same inputs give equal outputs. Both are mpmath and
numpy code on the host, so every comparison is exact (mpf values compared
as strings at the working precision, dps = 80), except the heap simulator,
whose float rates must agree to the last bit too (one seed, one generator).
"""

import mpmath
import numpy as np
import pytest
from mpmath import mpf

import quantum_computations_tpu.distill as jd
import quantum_computations_tpu.distill.explorer as jexplorer
from quantum_computations_tpu.utils.colour import Colour as JColour

import quantum_computations_tpu_torch.distill as td
import quantum_computations_tpu_torch.distill.explorer as texplorer
from quantum_computations_tpu_torch.distill.codes import filtered_codes as tfiltered
from quantum_computations_tpu.distill.codes import filtered_codes as jfiltered
from quantum_computations_tpu_torch.utils.colour import Colour as TColour


def _s(x):
    """mpf (or nested lists of them) as exact strings."""
    if isinstance(x, (list, tuple)):
        return [_s(v) for v in x]
    return str(x)


def test_codes_table_equals_jax():
    assert td.load_codes_table() == jd.load_codes_table()
    assert len(td.load_codes_table()) > 1000
    assert tfiltered(12) == jfiltered(12)


@pytest.mark.parametrize("n,basis", [(2, "Z"), (3, "X"), (5, "Y")])
def test_repetition_evaluator_equals_jax(n, basis):
    p = mpf("0.01")
    got, want = td.ED_n_1_n(n, p, basis=basis), jd.ED_n_1_n(n, p, basis=basis)
    assert _s(got) == _s(want)


def _sequence(pkg):
    seq = pkg.LogicalDistillationSequence(pkg.InitStage(mpf("1.25e-2"), 3, mpf("0.001")))
    seq.add_stage(pkg.ClassicalStage((2, 1, 2), "X", seq.L, seq.p_L, mpf("0.001")))
    seq.add_stage(pkg.ClassicalStage((2, 1, 2), "Y", seq.L, seq.p_L, mpf("0.001")))
    return seq


def test_sequence_recurrences_and_serialisation_equal_jax():
    t, j = _sequence(td), _sequence(jd)
    assert _s([t.p_out, t.encoding_rate, t.K, t.min_memory_req]) == \
        _s([j.p_out, j.encoding_rate, j.K, j.min_memory_req])
    assert t.serialise() == j.serialise()
    back = td.LogicalDistillationSequence.deserialise(j.serialise())
    assert _s(back.p_out) == _s(j.p_out)


def test_small_dfs_search_equals_jax():
    """A depth-3 search to 1e-4 within 3000 qubits (under a second)."""
    def search(pkg):
        local, targ = mpf("0.1e-2"), mpf("1e-4")
        L = pkg.surface_code_size(local, targ)
        init = pkg.LogicalDistillationSequence(pkg.InitStage(mpf("1.25e-2"), 3, local))
        args = pkg.DFSArgs(local, 3000, targ, L, 0, code_sizes=list(range(0, L)),
                           max_seq_len=3)
        return pkg.dfs_code_sequence(args, init)

    t, j = search(td), search(jd)
    assert t is not None and j is not None
    assert [str(s) for s in t.stages] == [str(s) for s in j.stages]
    assert _s([t.encoding_rate, t.p_out]) == _s([j.encoding_rate, j.p_out])


def test_rate_surface_round_trip_equals_jax(tmp_path):
    x = np.logspace(-2, 0, 5)
    y = np.arange(1000, 6000, 1000)
    r1 = np.random.default_rng(0).random((5, 5))
    r2 = np.zeros((5, 5))
    texplorer.save_rate_surfaces(tmp_path / "t.dat", x, y, [r1, r2], ["A", "B"])
    jexplorer.save_rate_surfaces(tmp_path / "j.dat", x, y, [r1, r2], ["A", "B"])
    assert (tmp_path / "t.dat").read_text() == (tmp_path / "j.dat").read_text()
    tx, ty, trs, tlab = texplorer.load_rate_surfaces(tmp_path / "j.dat")
    jx, jy, jrs, jlab = jexplorer.load_rate_surfaces(tmp_path / "j.dat")
    for a, b in zip((tx, ty, *trs), (jx, jy, *jrs)):
        np.testing.assert_array_equal(a, b)
    assert tlab == jlab == ["A", "B"]
    (tZ, tids), (jZ, jids) = texplorer.regime_map(trs), jexplorer.regime_map(jrs)
    np.testing.assert_array_equal(tZ, jZ)
    np.testing.assert_array_equal(tids, jids)


def test_heap_simulator_equals_jax_at_a_fixed_seed():
    outs = []
    for pkg in (td, jd):
        seq = _sequence(pkg)
        sim = pkg.Simulator(10 * seq.min_memory_req, mpmath.inf, seq, rng_seed=1)
        outs.append(sim.run(2000, collect_data=True))
    t, j = outs
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k], dtype=float),
                                      np.asarray(j[k], dtype=float), err_msg=k)
    assert t["rate"] > 0


def test_colour_wrap_equals_jax():
    got = TColour.wrap("hi", TColour.RED, TColour.BOLD)
    assert got == JColour.wrap("hi", JColour.RED, JColour.BOLD)
    assert got.startswith(TColour.RED) and got.endswith(TColour.RESET)
