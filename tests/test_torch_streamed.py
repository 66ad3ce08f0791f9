"""The port's streamed two-mode split (``ops/streamed``, with
``ops/linalg.orthonormalize(method="ns")`` and the routing in
``cv/gates``) against the JAX package, on the CPU.

The same tensors (numpy, from a seed) go through both packages at x64.
The port draws each split's sketch through ``ops.streamed._stream_sketch``;
the tests replace it to replay the JAX driver's own
``jax.random.normal(key, (d, b, l))`` draws, in the order the JAX splits
make them. Tolerances (relative to the largest magnitude):
- 1e-8 for a split (compared through the contracted m1 . m2, since the
  host eigh fixes each singular vector only up to a phase) and for a whole
  four-mode ``cv.Simulator`` chain with streamed splits and forced
  outcomes; kept ranks exactly;
- 1e-12 for the Newton–Schulz inverse square root and the
  orthonormalization of a well-conditioned matrix (the same float64
  matmuls in another order), 1e-8 of a rank-deficient one;
- the JAX test's own criteria for streamed against materialised
  (reconstruction error within 1.5x the dropped mass of the exact SVD,
  kept s^2 within 1e-2) and for the three-CZ BS on physical states (2e-2);
- 2e-5 absolute (about 10x complex64's floor on that matrix) for the
  port's own complex64 randomized SVD of an exactly rank-8 matrix.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import quantum_computations_tpu.cv.gates as jg
import quantum_computations_tpu.ops.linalg as jlinalg
import quantum_computations_tpu.ops.streamed as jst
from quantum_computations_tpu.cv import MPS as JMPS, Simulator as JSim, State as JState
from quantum_computations_tpu_torch import config as tconfig
from quantum_computations_tpu_torch.cv import MPS as TMPS, Simulator as TSim, State as TState
from quantum_computations_tpu_torch.cv import gates as tg
from quantum_computations_tpu_torch.ops import interp as tinterp
from quantum_computations_tpu_torch.ops import linalg as tlinalg
from quantum_computations_tpu_torch.ops import streamed as tst

REPO = Path(__file__).resolve().parent.parent
SPLIT_TOL = 1e-8
NS_TOL = 1e-12
NS_DEFICIENT_TOL = 1e-8
EPS = float(2 * np.arctanh(10 ** (-10 / 10) / 2))  # 10 dB
WARPS = [("rot", 0.7), ("shear", 1.0, True), ("shear", 1.0, False),
         ("cz", 1.0), ("swap",), ("id",)]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _pair(seed=0, a=4, d=64, k=3, b=2):
    rng = np.random.default_rng(seed)
    t1 = rng.normal(size=(a, d, k)) + 1j * rng.normal(size=(a, d, k))
    t2 = rng.normal(size=(k, d, b)) + 1j * rng.normal(size=(k, d, b))
    return t1, t2


def _physical_pair(qs):
    g = np.exp(-qs ** 2 / 2)
    modes = np.stack([g, 0.3 * g * qs, 0.05 * g * (qs ** 2 - 1)], axis=0)
    t1 = (modes.T[None, :, :] * (1 + 0.1j)).astype(complex)   # (1, d, 3)
    t2 = (modes[:, :, None] * (1 - 0.05j)).astype(complex)    # (3, d, 1)
    return t1, t2


def _record_jax_stream_sketches(monkeypatch):
    """The JAX driver's sketches, in the order its splits draw them."""
    sketches = []
    real = jst._streamed_driver

    def record(t1, t2, qs, warp_params, **kw):
        a, d, _ = t1.shape
        b = t2.shape[-1]
        cap = min(kw["max_bond_dim"], a * d, d * b)
        l = min(cap + jlinalg.OVERSAMPLE, a * d, d * b)
        sketches.append(np.array(jax.random.normal(kw["key"], (d, b, l),
                                                   dtype=jnp.float64)))
        return real(t1, t2, qs, warp_params, **kw)

    monkeypatch.setattr(jst, "_streamed_driver", record)
    return sketches


def _replay_stream_sketches(monkeypatch, sketches):
    def replay(d, b, l, generator, like):
        o = sketches.pop(0)
        assert o.shape == (d, b, l)
        return torch.from_numpy(o).to(like.dtype)

    monkeypatch.setattr(tst, "_stream_sketch", replay)


def _jax_split(t1, t2, qs, warp, **kw):
    m1, m2, rank = jst.streamed_pair_svd(jnp.asarray(t1), jnp.asarray(t2),
                                         jnp.asarray(qs), warp,
                                         key=jax.random.PRNGKey(0), **kw)
    return np.einsum("abj,jcd->abcd", np.asarray(m1), np.asarray(m2)), int(rank)


def _port_split(t1, t2, qs, warp, **kw):
    m1, m2, rank = tst.streamed_pair_svd(
        torch.from_numpy(t1), torch.from_numpy(t2), torch.from_numpy(qs), warp,
        generator=torch.Generator(), **kw)
    assert isinstance(rank, int) and m1.dtype == torch.complex128
    return torch.einsum("abj,jcd->abcd", m1, m2).numpy(), rank, m1


SPLIT = dict(max_bond_dim=8, abs_err=0.0, rel_err=1e-3, power_iters=7)


@pytest.mark.parametrize("decomp,warp", [("rot", w) for w in WARPS]
                         + [("cz", w) for w in WARPS[:3]])
def test_streamed_split_matches_jax(monkeypatch, decomp, warp):
    """``decomp`` is ``_BS_DECOMP`` in both packages: "rot" drives every
    warp through one direct split, "cz" a BS through three CZ splits and a
    CX through one."""
    monkeypatch.setattr(jst, "_BS_DECOMP", decomp)
    monkeypatch.setattr(tst, "_BS_DECOMP", decomp)
    t1, t2 = _pair()
    qs = np.linspace(-5, 5, 64)
    sketches = _record_jax_stream_sketches(monkeypatch)
    want, rank = _jax_split(t1, t2, qs, warp, **SPLIT)
    assert len(sketches) == (3 if decomp == "cz" and warp[0] == "rot" else 1)
    _replay_stream_sketches(monkeypatch, sketches)
    got, got_rank, _ = _port_split(t1, t2, qs, warp, **SPLIT)
    assert not sketches
    assert got_rank == rank
    _close(got, want, SPLIT_TOL)


def _materialised_criteria(t1, t2, qs, warp, m1, full, rank):
    """The JAX test's criteria: reconstruction error within 1.5x the
    dropped singular mass of an exact SVD; kept s^2 within 1e-2."""
    res = tinterp.affine_warp(torch.from_numpy(qs),
                              torch.tensordot(torch.from_numpy(t1),
                                              torch.from_numpy(t2), dims=1),
                              warp).numpy()
    a, d = t1.shape[:2]
    b = t2.shape[-1]
    m = res.reshape(a * d, d * b)
    s_exact = np.linalg.svd(m, compute_uv=False)
    dropped = s_exact[rank:].sum()
    err = np.linalg.norm(full.reshape(m.shape) - m, ord="fro")
    assert err <= dropped * 1.5 + 1e-6, (err, dropped)
    kept = np.sort(np.linalg.norm(m1.reshape(a * d, -1).numpy(), axis=0))[::-1][:rank]
    np.testing.assert_allclose(kept ** 2, s_exact[:rank], rtol=1e-2)


@pytest.mark.parametrize("warp", WARPS[:5])
def test_streamed_matches_materialised(monkeypatch, warp):
    monkeypatch.setattr(tst, "_BS_DECOMP", "rot")
    t1, t2 = _pair()
    qs = np.linspace(-5, 5, 64)
    full, rank, m1 = _port_split(t1, t2, qs, warp, **SPLIT)
    _materialised_criteria(t1, t2, qs, warp, m1, full, rank)


def test_streamed_multi_chunk_both_axes(monkeypatch):
    """A one-(1, d, d, 1)-block budget chunks both bond axes fully; the
    split still meets the criteria and equals the JAX package's."""
    monkeypatch.setattr(jst, "_BS_DECOMP", "rot")
    monkeypatch.setattr(tst, "_BS_DECOMP", "rot")
    monkeypatch.setattr(jst, "_BLOCK_ELEMENTS", 64 * 64)
    monkeypatch.setattr(tst, "_BLOCK_ELEMENTS", 64 * 64)
    assert tst._pick_chunks(4, 64, 2) == jst._pick_chunks(4, 64, 2) == (1, 1)
    t1, t2 = _pair()
    qs = np.linspace(-5, 5, 64)
    sketches = _record_jax_stream_sketches(monkeypatch)
    want, rank = _jax_split(t1, t2, qs, ("rot", 0.7), **SPLIT)
    _replay_stream_sketches(monkeypatch, sketches)
    got, got_rank, m1 = _port_split(t1, t2, qs, ("rot", 0.7), **SPLIT)
    assert got_rank == rank
    _close(got, want, SPLIT_TOL)
    _materialised_criteria(t1, t2, qs, ("rot", 0.7), m1, got, got_rank)


def test_pick_chunks_matches_jax():
    for shape, budget in (((4, 64, 2), None), ((6, 10, 9), 1200), ((7, 8, 5), 64 * 3),
                          ((12, 5, 8), 1), ((100, 1000, 100), 1 << 25)):
        assert tst._pick_chunks(*shape, budget) == jst._pick_chunks(*shape, budget)


def test_rot_via_cz_on_physical_states(monkeypatch):
    """The three-CZ BS and one-CZ CX splits (``_BS_DECOMP = "cz"``) agree
    with the materialised warp on smooth physical states."""
    monkeypatch.setattr(tst, "_BS_DECOMP", "cz")
    qs = np.linspace(-8, 8, 80)
    t1, t2 = _physical_pair(qs)
    for warp in (("rot", np.pi / 4), ("shear", 0.8, True), ("shear", 0.8, False)):
        got, _, _ = _port_split(t1, t2, qs, warp, max_bond_dim=6, abs_err=0.0,
                                rel_err=1e-4, power_iters=7)
        ref = tinterp.affine_warp(torch.from_numpy(qs),
                                  torch.tensordot(torch.from_numpy(t1),
                                                  torch.from_numpy(t2), dims=1),
                                  warp).numpy()
        assert np.abs(got - ref).max() < 2e-2 * np.abs(ref).max(), warp


@pytest.mark.parametrize("env", [None, "3", "ref"])
def test_effective_power_iters_matches_jax(monkeypatch, env):
    monkeypatch.setattr(jst, "_POWER_ITERS_ENV", env)
    monkeypatch.setattr(tst, "_POWER_ITERS_ENV", env)
    for q in (4, 7):
        assert tst.effective_power_iters(q) == jst.effective_power_iters(q)
    assert tst.effective_power_iters(7) == {None: 2, "3": 3, "ref": 7}[env]


def test_environment_settings_are_read_at_import():
    code = ("from quantum_computations_tpu_torch.cv import gates\n"
            "from quantum_computations_tpu_torch.ops import streamed\n"
            "print(gates._STREAM_THRESHOLD, streamed._BS_DECOMP, "
            "streamed.effective_power_iters(7))\n")
    # the BS route is not an environment setting: the direct split by default
    env = dict(os.environ, QCT_STREAM_THRESHOLD="12345", QCT_BS_DECOMP="cz",
               QCT_STREAM_POWER_ITERS="ref")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["12345", "rot", "7"]
    assert tg._STREAM_THRESHOLD == int(os.environ.get("QCT_STREAM_THRESHOLD", 1 << 28))


@pytest.mark.parametrize("rank", [110, 6])
def test_ns_inverse_sqrt_and_orthonormalize_match_jax(rank):
    """A well-conditioned tall matrix, and a rank-deficient one (the
    streamed split's case: rank r << l columns), whose null space the
    1e-7 ridge fills with float64 rounding amplified up to ~3e3x."""
    rng = np.random.default_rng(rank)
    Y = rng.normal(size=(400, rank)) + 1j * rng.normal(size=(400, rank))
    if rank < 110:
        Y = Y @ (rng.normal(size=(rank, 110)) + 1j * rng.normal(size=(rank, 110)))
    tol = NS_TOL if rank == 110 else NS_DEFICIENT_TOL
    G = Y.conj().T @ Y
    _close(tlinalg._ns_inv_sqrt(torch.from_numpy(G)).numpy(),
           np.asarray(jlinalg._ns_inv_sqrt(jnp.asarray(G))), tol)
    Q = tlinalg.orthonormalize(torch.from_numpy(Y), method="ns").numpy()
    _close(Q, np.asarray(jlinalg.orthonormalize(jnp.asarray(Y), method="ns")), tol)
    _close(Q @ (Q.conj().T @ Y), Y, NS_DEFICIENT_TOL)  # Q spans Y's range
    if rank == 110:
        np.testing.assert_allclose(Q.conj().T @ Q, np.eye(110), atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_svd_complex64_of_a_rank_deficient_matrix(seed):
    """An exactly rank-8 (2000, 2000) matrix with a flat spectrum, as the
    port's complex64 randomized SVD meets it in a GKP circuit (l = 110
    sketch columns, 8 of them signal): the range finder's Gram is formed
    in complex128, so the rank-8 split is exact to complex64's floor. With
    a complex64 Gram its rounding (~1e-7 of the largest eigenvalue) sat
    above the 1e-12 eigenvalue floor, and the split was off by ~1e-3."""
    rng = np.random.default_rng(seed)
    n, r = 2000, 8
    u, v = (np.linalg.qr(rng.normal(size=(n, r)) + 1j * rng.normal(size=(n, r)))[0]
            for _ in range(2))
    A = torch.from_numpy((u * np.linspace(1, 0.9, r)) @ v.conj().T).to(torch.complex64)
    O = torch.from_numpy(rng.normal(size=(n, 110))).to(torch.complex64)
    U, s, Vh = tlinalg.randomized_truncated_svd(A, 100, sketch=O)
    rank = int(tlinalg.truncation_rank_mask(s, 100, 0.0, 1e-2)[0])
    assert rank == r
    approx = (U[:, :r].to(torch.complex128) * s[:r].double()) @ Vh[:r].to(torch.complex128)
    assert float(torch.linalg.matrix_norm(A.to(torch.complex128) - approx)) < 2e-5


def test_split_routes_above_the_threshold(monkeypatch):
    """Above the threshold (with a bond cap) a gate's split streams: the
    streamed function runs once and the materialised SVD never."""
    opts = tconfig.SVDOptions(max_bond_dim=100)
    assert tg._use_streamed(100, 1000, 100, opts)       # interior pair at chi = 100
    assert not tg._use_streamed(1, 1000, 100, opts)     # a pair at an end of the chain
    assert not tg._use_streamed(100, 1000, 100, tconfig.SVDOptions())
    calls = {"streamed": 0, "tensor_svd": 0}
    real_streamed, real_svd = tst.streamed_pair_svd, tg.tensor_svd

    def streamed(*a, **k):
        calls["streamed"] += 1
        return real_streamed(*a, **k)

    def svd(*a, **k):
        calls["tensor_svd"] += 1
        return real_svd(*a, **k)

    monkeypatch.setattr(tg, "streamed_pair_svd", streamed)
    monkeypatch.setattr(tg, "tensor_svd", svd)
    qs = np.linspace(-8, 8, 80)
    t1, t2 = _physical_pair(qs)
    opts = tconfig.SVDOptions(max_bond_dim=6, rel_err=1e-4)

    def run(threshold):
        monkeypatch.setattr(tg, "_STREAM_THRESHOLD", threshold)
        mps = TMPS.from_numpy(qs, [t1, t2], device="cpu")
        tg.CZ(0, 1).apply(mps, generator=torch.Generator().manual_seed(0),
                          svd_options=opts)
        return torch.tensordot(mps[0], mps[1], dims=1)

    big = run(80 * 80)  # CZ(0, 1) contracts 1 x 80 x 80 x 1 elements
    assert calls == {"streamed": 0, "tensor_svd": 1}
    small = run(80 * 80 - 1)
    assert calls == {"streamed": 1, "tensor_svd": 1}
    # the JAX test's bound for streamed against materialised
    assert (big - small).abs().max() < 2e-2 * big.abs().max()


def test_a_failed_streamed_split_raises(monkeypatch):
    """No fallback: a split whose Gram is not finite raises, and the chain
    is left as it was."""
    monkeypatch.setattr(tg, "_STREAM_THRESHOLD", 1)
    qs = np.linspace(-8, 8, 80)
    t1, t2 = _physical_pair(qs)
    t1[0, 3, 1] = np.nan
    mps = TMPS.from_numpy(qs, [t1, t2], device="cpu")
    before = list(mps.tensors)
    with pytest.raises(FloatingPointError, match="non-finite"):
        tg.BS(0, 1).apply(mps, generator=torch.Generator(),
                          svd_options=tconfig.SVDOptions(max_bond_dim=6))
    assert len(mps) == 2 and all(a is b for a, b in zip(before, mps.tensors))


def _chain_circuit(g, State, forced=()):
    """Four modes from a GKP_H data mode; every two-mode gate class acts
    on the interior pairs (1, 2) and (2, 1)."""
    f = iter(forced)
    m = lambda: next(f, None)  # noqa: E731
    return [g.Insert(1, State.GKP_ZERO, gkp_epsilon=EPS),
            g.Insert(2, State.QUNAUGHT, gkp_epsilon=EPS),
            g.Insert(3, State.GKP_PLUS, gkp_epsilon=EPS),
            g.BS(0, 1), g.CZ(2, 3), g.BS(1, 2), g.CX(2, 1), g.CZ(1, 2),
            g.SWAP(1, 2), g.BS(2, 1, 0.3), g.Mq(3, result=m()),
            g.Mp(0, result=m()), g.Homodyne(1, np.pi / 3, result=m())]


def test_four_mode_chain_streams_and_matches_jax(monkeypatch):
    """A whole ``cv.Simulator`` run with both packages' thresholds lowered
    so that the interior splits stream; JAX's outcomes, its streamed
    sketches and its randomized-SVD sketches are replayed in the port."""
    d = 64
    qs = np.linspace(-12, 12, d)
    opts = {"max_bond_dim": 8, "rel_err": 1e-2}
    monkeypatch.setattr(jg, "_STREAM_THRESHOLD", 16 * d * d)
    monkeypatch.setattr(tg, "_STREAM_THRESHOLD", 16 * d * d)
    # both packages split a streamed BS by the port's default route
    monkeypatch.setattr(jst, "_BS_DECOMP", tst._BS_DECOMP)
    sketches = _record_jax_stream_sketches(monkeypatch)
    rsvd = []
    real_rrf = jlinalg.randomized_range_finder

    def record_rsvd(A, l, q, key):
        rsvd.append(np.array(jax.random.normal(key, (A.shape[1], l), dtype=A.real.dtype)))
        return real_rrf(A, l, q, key)

    monkeypatch.setattr(jlinalg, "randomized_range_finder", record_rsvd)
    jsim = JSim(_chain_circuit(jg, JState), rng_seed=4, svd_options=opts)
    jout = jsim.run(JMPS(qs, [JState.GKP_H.eval(qs, EPS)]))
    outcomes = [float(r.result) for r in jsim.results]
    n_streamed = len(sketches)
    assert n_streamed >= 3

    _replay_stream_sketches(monkeypatch, sketches)

    def replay_rsvd(n, l, generator, like):
        o = rsvd.pop(0)
        assert o.shape == (n, l)
        return torch.from_numpy(o).to(like.dtype)

    monkeypatch.setattr(tlinalg, "_gaussian_sketch", replay_rsvd)
    tsim = TSim(_chain_circuit(tg, TState, outcomes), rng_seed=4, svd_options=opts)
    tout = tsim.run(TMPS(qs, [TState.GKP_H.eval(qs, EPS, device="cpu")]))
    assert not sketches and not rsvd
    assert [r.result for r in tsim.results] == outcomes
    for a, b in zip(tsim.results, jsim.results):
        _close(float(a.probability), float(b.probability), SPLIT_TOL)
    assert tout.shape() == jout.shape()
    _close(tout.contract().numpy(), jout.contract(), SPLIT_TOL)
    for k in range(len(tout)):
        _close(tout.partial_density_mps(k).numpy(), jout.partial_density_mps(k), SPLIT_TOL)
