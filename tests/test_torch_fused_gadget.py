"""The port's fused gadgets (``ops/fused_gadget``) and the batched small
numerics they stand on (``ops/linalg._ns_inv_sqrt``, ``ops/interp.rotation``
with one angle per trajectory) against the JAX package, on the CPU at x64.

The chains are the JAX test's (``tests/test_fused_gadget.py``): two GKP
modes entangled by a CZ for the single gadget, four modes entangled by
three CZs for the pair measure, built by the JAX package and handed to the
port as numpy with a batch axis of one. The JAX function draws an outcome
pair first; both packages then run with it forced. Tolerances, relative to
the largest magnitude: 1e-8 for the distributions (rho1, rho2), the drawn
probabilities, the outcomes and every output tensor; 1e-12 for the
grid tables and small numerics; paths and flags exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quantum_computations_tpu.config import SVDOptions
from quantum_computations_tpu.cv import gates as jcg
from quantum_computations_tpu.cv.mps import MPS
from quantum_computations_tpu.cv.states import State as JCV
from quantum_computations_tpu.gkp import db2eps
from quantum_computations_tpu.ops import fused_gadget as J
from quantum_computations_tpu.ops import interp as jinterp
from quantum_computations_tpu.ops import linalg as jlinalg

from quantum_computations_tpu_torch.ops import fused_gadget as T
from quantum_computations_tpu_torch.ops import interp as tinterp
from quantum_computations_tpu_torch.ops import linalg as tlinalg

TOL = 1e-8
EXACT_TOL = 1e-12
EPS = float(db2eps(8.0))
KEY = jax.random.PRNGKey(7)
ARCTAN2 = float(np.arctan(2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread per test process: the tier-1 run puts six
    test processes on the machine's cores, where torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), err


def _grid(n=160):
    return np.linspace(-10.0, 10.0, n)


def _bell(qs):
    zero = JCV.GKP_ZERO.eval(jnp.asarray(qs), EPS)
    one = JCV.GKP_ONE.eval(jnp.asarray(qs), EPS)
    return jnp.stack([2 ** (-1 / 4) * zero, 2 ** (-1 / 4) * one], axis=-1)


def _entangled_chain(qs):
    plus = JCV.GKP_PLUS.eval(jnp.asarray(qs), EPS).reshape(1, -1, 1)
    zero = JCV.GKP_ZERO.eval(jnp.asarray(qs), EPS).reshape(1, -1, 1)
    mps = MPS(qs, [plus, zero])
    jcg.CZ(0, 1).apply(mps, key=KEY, svd_options=SVDOptions(max_bond_dim=24, rel_err=1e-8))
    return mps.tensors


def _four_mode_chain(qs):
    states = [JCV.GKP_PLUS, JCV.GKP_ZERO, JCV.GKP_PLUS, JCV.GKP_ZERO]
    mps = MPS(qs, [s.eval(jnp.asarray(qs), EPS).reshape(1, -1, 1) for s in states])
    opts = SVDOptions(max_bond_dim=16, rel_err=1e-8)
    jcg.CZ(0, 1).apply(mps, key=KEY, svd_options=opts)
    jcg.CZ(2, 3).apply(mps, key=KEY, svd_options=opts)
    jcg.CZ(1, 2).apply(mps, key=KEY, svd_options=opts)
    return mps.tensors


def _batched(tensors):
    return [torch.from_numpy(np.array(t))[None] for t in tensors]


_CHAINS = {}


def _chain(kind, n):
    if (kind, n) not in _CHAINS:
        qs = _grid(n)
        _CHAINS[kind, n] = (_entangled_chain if kind == "two" else _four_mode_chain)(qs)
    return _CHAINS[kind, n]


def _same(got, want, swapped=None):
    """Port output (batch of one) against the JAX function's."""
    (tt, tm1, tm2, td), (jt, jm1, jm2, jd) = got, want
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        _close(a[0].numpy(), b, TOL)
    _close(tm1[0], jm1, TOL)
    _close(tm2[0], jm2, TOL)
    for k in ("rho1", "rho2", "p1", "p2"):
        _close(td[k][0].numpy(), jd[k], TOL)
    assert int(td["i"][0]) == int(jd["i"]) and int(td["j"][0]) == int(jd["j"])
    if swapped is not None:
        assert td["swapped"] is jd["swapped"] is swapped


# ---------------------------------------------------------------------------
# small numerics and grid tables
# ---------------------------------------------------------------------------

def test_ns_inv_sqrt_takes_each_matrix_trace():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 5, 5)) + 1j * rng.normal(size=(3, 5, 5))
    G = X @ X.conj().transpose(0, 2, 1) + 5 * np.eye(5)
    G[1] *= 1e3  # traces far apart
    got = tlinalg._ns_inv_sqrt(torch.from_numpy(G)).numpy()
    for z in range(3):
        _close(got[z], jlinalg._ns_inv_sqrt(jnp.asarray(G[z])), EXACT_TOL)
        _close(got[z] @ G[z] @ got[z], np.eye(5), 1e-6)


def test_psd_sqrt_and_environments_match_jax():
    rng = np.random.default_rng(1)
    for n in (1, 2, 6):
        X = rng.normal(size=(2, n, n)) + 1j * rng.normal(size=(2, n, n))
        G = X @ X.conj().transpose(0, 2, 1)
        got = T._psd_sqrt(torch.from_numpy(G)).numpy()
        for z in range(2):
            _close(got[z], J._psd_sqrt(jnp.asarray(G[z])), EXACT_TOL)
    tensors = _chain("four", 160)
    bt = _batched(tensors)
    for k in range(len(tensors) + 1):
        _close(T._left_env(bt[:k], bt[0])[0].numpy(), J._left_env(tensors[:k]), EXACT_TOL)
        _close(T._right_env(bt[k:], bt[0])[0].numpy(), J._right_env(tensors[k:]), EXACT_TOL)


@pytest.mark.parametrize("n", [160, 161])
@pytest.mark.parametrize("stretch,refine", [(np.sqrt(0.5), 1), (np.sqrt(0.5), 2), (0.5, 2), (0.8660254, 1)])
def test_stretch_sample_matrix_and_shifts_match_jax(n, stretch, refine):
    qs = _grid(n)
    pad = int(np.ceil((n - 1) / 2)) + 1
    S, M, h = T._stretch_sample_matrix(qs, stretch, refine, pad)
    jS, jM, jh = J._stretch_sample_matrix(qs, stretch, refine, pad)
    assert (M, h) == (jM, jh) and S.dtype == torch.float64
    _close(S.numpy(), jS, EXACT_TOL)
    rng = np.random.default_rng(n)
    lines = rng.normal(size=(3, M)) + 1j * rng.normal(size=(3, M))
    freqs = np.fft.fftfreq(M, d=h)
    deltas = qs[::17] * stretch
    got = T._shift_eval(torch.from_numpy(lines), torch.from_numpy(freqs),
                        torch.from_numpy(deltas))
    want = J._shift_eval(jnp.asarray(lines), jnp.asarray(freqs), jnp.asarray(deltas))
    _close(got.numpy(), want, EXACT_TOL)
    _close(T._core_slice(got, refine, pad, n).numpy(),
           J._core_slice(want, refine, pad, n), EXACT_TOL)


def test_rotation_with_one_angle_per_trajectory():
    qs = _grid(64)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 2, 64, 4)) + 1j * rng.normal(size=(3, 2, 64, 4))
    theta = np.array([0.3, ARCTAN2, -np.pi / 2])
    got = tinterp.rotation(qs, torch.from_numpy(x), theta, axis=2).numpy()
    for z in range(3):
        _close(got[z], jinterp.rotation(jnp.asarray(qs), jnp.asarray(x[z]), theta[z], axis=1),
               EXACT_TOL)


def test_rotation_kernel_row_matches_jax():
    qs = _grid(160)
    q_m = np.array([qs[3], qs[80], qs[151]])
    got = T._rotation_kernel_row(torch.from_numpy(qs), -ARCTAN2, torch.from_numpy(q_m)).numpy()
    for z in range(3):
        _close(got[z], J._rotation_kernel_row(jnp.asarray(qs), -ARCTAN2, q_m[z]), EXACT_TOL)


ANGLES = [0.0, 1e-13, -1e-13, 1e-9, np.pi / 4, -np.pi / 4, np.pi / 2, -np.pi / 2,
          ARCTAN2, -ARCTAN2, np.pi / 3, np.pi, -np.pi, np.pi / 3 + np.pi, 2.5]


@pytest.mark.parametrize("prerot", [None, True, False])
def test_pair_measure_path_and_prerot_applies_match_jax(prerot):
    for a1 in ANGLES:
        for a2 in ANGLES:
            assert T._prerot_applies(a1, a2) == J._prerot_applies(a1, a2), (a1, a2)
            assert T.pair_measure_path(a1, a2, prerot) == \
                J.pair_measure_path(a1, a2, prerot), (a1, a2)
        # one angle per trajectory takes the JAX package's traced branch
        assert T._prerot_applies(a1, np.array([0.0, 1.0])) == (a1 != 0.0)
        assert T.pair_measure_path(a1, np.array([0.0, 1.0]), prerot) in (
            ("a1zero",) if a1 == 0.0 else ("prerot",) if prerot in (None, True) else ("exact",))


# ---------------------------------------------------------------------------
# fused_single_gadget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx,a1,a2", [
    (0, 0.0, np.pi / 2),       # identity/P-family gadget on the left mode
    (1, 0.0, ARCTAN2),         # P gadget on the right mode
    (0, np.pi / 4, -np.pi / 4),  # Hadamard gadget angles
])
def test_fused_single_matches_jax(idx, a1, a2):
    qs = _grid()
    tensors = _chain("two", 160)
    bell = _bell(qs)
    probe = J.fused_single_gadget(list(tensors), idx, qs, bell, a1, a2, KEY, diagnostics=True)
    force = (int(probe[3]["i"]), int(probe[3]["j"]))
    want = J.fused_single_gadget(list(tensors), idx, qs, bell, a1, a2, KEY,
                                 force=force, diagnostics=True)
    got = T.fused_single_gadget(_batched(tensors), idx, qs,
                                torch.from_numpy(np.array(bell)), a1, a2,
                                force=force, diagnostics=True)
    _same(got, want)
    assert [t.shape[1:] for t in got[0]] == [t.shape for t in tensors]


def test_fused_single_batch_equals_single_calls():
    """Two trajectories with their own a2, Bell phase and chain in one call
    equal two calls with a batch of one."""
    qs = _grid()
    tensors = _chain("two", 160)
    rng = np.random.default_rng(3)
    other = [t * np.exp(1j * rng.uniform()) * (1 + 0.1 * rng.normal(size=t.shape))
             for t in map(np.array, tensors)]
    bt = [torch.cat([a, b]) for a, b in zip(_batched(tensors), _batched(other))]
    bell = torch.from_numpy(np.array(_bell(qs)))
    bells = torch.stack([bell, bell * torch.tensor([1.0, np.exp(1j * np.pi / 8)])])
    a2 = np.array([ARCTAN2, np.pi / 2], np.float32)
    force = (np.array([70, 90]), np.array([82, 75]))
    got = T.fused_single_gadget(bt, 1, qs, bells, 0.0, a2, force=force, diagnostics=True)
    for z in range(2):
        one = T.fused_single_gadget([t[z:z + 1] for t in bt], 1, qs, bells[z], 0.0,
                                    a2[z:z + 1], force=(force[0][z], force[1][z]),
                                    diagnostics=True)
        for a, b in zip(got[0], one[0]):
            _close(a[z].numpy(), b[0].numpy(), EXACT_TOL)
        for k in ("rho1", "rho2", "p1", "p2"):
            _close(got[3][k][z].numpy(), one[3][k][0].numpy(), EXACT_TOL)


def test_unforced_draws_follow_the_inverse_cdf(monkeypatch):
    """A draw is the first bin whose cumulative weight exceeds u times the
    total: fixed uniforms pick the expected indices, zero bins never."""
    dist = torch.tensor([[0.0, 1.0, 0.0, 3.0, 0.0],
                         [2.0, 0.0, 0.0, 0.0, 2.0]], dtype=torch.float64)
    for u, want in (([0.0, 0.0], [1, 0]), ([0.2, 0.49], [1, 0]), ([0.25, 0.5], [3, 4]),
                    ([0.999, 0.999], [3, 4])):
        monkeypatch.setattr(T, "_uniforms", lambda n, g, dev, u=u: torch.tensor(u, dtype=torch.float64))
        assert T._draw(dist, None, None).tolist() == want
    gen = torch.Generator().manual_seed(0)
    monkeypatch.undo()
    counts = np.bincount(np.concatenate([T._draw(dist, None, gen).numpy()[None]
                                         for _ in range(2000)]).T[0], minlength=5)
    assert counts[0] == counts[2] == counts[4] == 0
    assert abs(counts[3] / 2000 - 0.75) < 0.04
    assert T._draw(dist, 2, None).tolist() == [2, 2]
    assert T._draw(dist, np.array([4, 1]), None).tolist() == [4, 1]
    with pytest.raises(ValueError):
        T._draw(dist, None, None)


def test_fused_single_draws_from_the_generator():
    """Unforced, one seed gives the same outcomes; the outcomes are grid
    points of positive weight."""
    qs = _grid()
    bt = _batched(_chain("two", 160))
    bell = torch.from_numpy(np.array(_bell(qs)))
    runs = [T.fused_single_gadget(bt, 0, qs, bell, 0.0, np.pi / 2,
                                  torch.Generator().manual_seed(5), diagnostics=True)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    d = runs[0][3]
    assert float(d["p1"][0]) > 0 and float(d["p2"][0]) > 0
    assert float(runs[0][1][0]) == qs[int(d["i"][0])]


# ---------------------------------------------------------------------------
# fused_pair_measure2
# ---------------------------------------------------------------------------

PAIR_CASES = {
    "a1zero": (0.0, ARCTAN2, True),
    "swapped": (-np.pi / 2, 0.0, True),
    "prerot": (ARCTAN2, -ARCTAN2, True),
    "exact": (ARCTAN2, -ARCTAN2, False),
}


@pytest.mark.parametrize("n", [160, 161])
@pytest.mark.parametrize("gram", [True, False])
@pytest.mark.parametrize("path", sorted(PAIR_CASES))
def test_fused_pair_matches_jax(path, gram, n):
    a1, a2, prerot = PAIR_CASES[path]
    qs = _grid(n)
    tensors = _chain("four", n)
    assert T.pair_measure_path(a1, a2, prerot) == path
    probe = J.fused_pair_measure2(list(tensors), 1, qs, a1, a2, KEY, gram=gram,
                                  prerot=prerot, diagnostics=True)
    swapped = probe[3]["swapped"]
    i, j = int(probe[3]["i"]), int(probe[3]["j"])
    force = (j, i) if swapped else (i, j)
    want = J.fused_pair_measure2(list(tensors), 1, qs, a1, a2, KEY, force=force,
                                 gram=gram, prerot=prerot, diagnostics=True)
    got = T.fused_pair_measure2(_batched(tensors), 1, qs, a1, a2, force=force,
                                gram=gram, prerot=prerot, diagnostics=True)
    _same(got, want, swapped=(path == "swapped"))


@pytest.mark.parametrize("m", [0, 2])
def test_fused_pair_absorbs_into_either_neighbour(m):
    qs = _grid()
    tensors = _chain("four", 160)
    want = J.fused_pair_measure2(list(tensors), m, qs, 0.0, ARCTAN2, KEY,
                                 force=(75, 85), diagnostics=True)
    got = T.fused_pair_measure2(_batched(tensors), m, qs, 0.0, ARCTAN2,
                                force=(75, 85), diagnostics=True)
    _same(got, want)


def test_fused_pair_gram_fallback_at_another_bs_angle():
    """bs_angle = pi/3: gram=True falls back to the row scan, as in JAX."""
    qs = _grid()
    tensors = _chain("four", 160)
    want = J.fused_pair_measure2(list(tensors), 1, qs, 0.0, 0.3, KEY, bs_angle=np.pi / 3,
                                 force=(70, 90), gram=True, diagnostics=True)
    got_g = T.fused_pair_measure2(_batched(tensors), 1, qs, 0.0, 0.3, bs_angle=np.pi / 3,
                                  force=(70, 90), gram=True, diagnostics=True)
    got_l = T.fused_pair_measure2(_batched(tensors), 1, qs, 0.0, 0.3, bs_angle=np.pi / 3,
                                  force=(70, 90), gram=False, diagnostics=True)
    _same(got_g, want)
    for a, b in zip(got_g[0], got_l[0]):
        assert torch.equal(a, b)


def test_fused_pair_needs_a_symmetric_grid_and_a_neighbour():
    qs = np.linspace(-10.0, 12.0, 160)
    tensors = _batched(_chain("four", 160))
    with pytest.raises(ValueError):
        T.fused_pair_measure2(tensors, 1, qs, -np.pi / 2, 0.0, force=(1, 1))
    with pytest.raises(ValueError):
        T.fused_pair_measure2(_batched(_chain("two", 160)), 0, _grid(), 0.0, ARCTAN2,
                              force=(1, 1))
