"""The batched Hermitian eigensolver of the materialised BS split's Gram
matrices (``ops/herm_eigh_small.py``).

On the CPU: its plain version against ``torch.linalg.eigh`` (LAPACK) on
random Hermitian batches, rank-deficient PSD Grams with ``svd_gram``'s
diagonal ramp and spectra from 1 to 1e-30, and exactly degenerate
spectra; its parallel ordering; the split's functions through the plain
route against the LAPACK route; the routing of ``ops/linalg.py`` by device,
side and batch, and its convergence check at the next fetch; and ``_build.load`` under concurrent threads. Marked ``cuda``:
the kernel against the plain version and ``torch.linalg.eigh`` on a card,
its refusals, an unconverged matrix, and its launches in one RB batch of
``BatchedGKP``; on a
machine without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_eigh_small.py``.

Tolerances: eigenvalues to 1e-12 max|w|, ||G V - V diag w||_F to 1e-12
||G||_F and |V^H V - I| to 1e-12 (the Jacobi sweeps stop at an
off-diagonal norm of 1e-15 ||G||_F; LAPACK is as accurate); the split's
basis-free results (G^{-1/2}, U s Vh) to 1e-10 relative (G^{-1/2} on
Grams of condition 1e4, where a backward error of 1e-16 moves it by
~1e-12).
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.ops import _build, herm_eigh_small as hs, linalg
from quantum_computations_tpu_torch.utils import profiling

TOL = 1e-12
SIDES = [1, 2, 3, 32, 33, 110, 127, 128]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread per test process (the tier-1 run puts six
    test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _herm(B, n, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    return torch.from_numpy((X + X.conj().transpose(0, 2, 1)) / 2).to(device)


def _unitary(B, n, rng):
    X = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    return np.linalg.qr(X)[0]


def _gram(B, n, seed, device="cpu"):
    """Rank-deficient PSD Grams: the spectrum falls from 1 to 1e-30 over
    the first half and is zero after it, plus ``svd_gram``'s ramp."""
    rng = np.random.default_rng(seed)
    w = np.logspace(0, -30, n)
    w[(n + 1) // 2:] = 0
    Q = _unitary(B, n, rng)
    G = (Q * w) @ Q.conj().transpose(0, 2, 1)
    tr = np.trace(G, axis1=1, axis2=2).real
    G[:, np.arange(n), np.arange(n)] += np.arange(n) * (1e-15 * tr / n**2)[:, None]
    return torch.from_numpy(G).to(device)


def _degenerate(B, n, seed, device="cpu"):
    """Spectra {0, 1, 2}, each about a third of the side, exactly repeated."""
    rng = np.random.default_rng(seed)
    w = np.repeat([0.0, 1.0, 2.0], -(-n // 3))[:n]
    Q = _unitary(B, n, rng)
    return torch.from_numpy((Q * w) @ Q.conj().transpose(0, 2, 1)).to(device)


def _errors(G, w, V):
    """(eigenvalues, residual, orthonormality) errors, relative as above."""
    H = hs._hermitian_from_lower(G)
    w_ref = torch.linalg.eigh(H.cpu())[0].to(w.device)
    scale = w_ref.abs().amax(-1).clamp_min(1e-300)
    eye = torch.eye(G.shape[-1], dtype=V.dtype, device=V.device)
    return (((w - w_ref).abs().amax(-1) / scale).max().item(),
            (torch.linalg.matrix_norm(H @ V - V * w[..., None, :])
             / torch.linalg.matrix_norm(H).clamp_min(1e-300)).max().item(),
            (V.mH @ V - eye).abs().max().item())


def _assert_eigh(G, w, V, info):
    assert w.shape == G.shape[:-1] and V.shape == G.shape
    assert w.dtype == torch.float64 and V.dtype == torch.complex128
    errs = _errors(G, w, V)
    assert max(errs) <= TOL, errs
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    assert bool(((info >= 0) & (info <= hs.MAX_SWEEPS)).all()), info


# -- the plain version against LAPACK ------------------------------------

@pytest.mark.parametrize("B", [1, 10, 16])
@pytest.mark.parametrize("n", SIDES)
def test_plain_matches_lapack_random_hermitian(n, B):
    G = _herm(B, n, seed=100 * n + B)
    _assert_eigh(G, *hs.herm_eigh_small_plain(G))


@pytest.mark.parametrize("n,B", [(3, 10), (32, 16), (33, 1), (110, 10), (128, 1)])
def test_plain_matches_lapack_rank_deficient_gram(n, B):
    G = _gram(B, n, seed=n + B)
    w, V, info = hs.herm_eigh_small_plain(G)
    _assert_eigh(G, w, V, info)
    # the zero half of the spectrum stays at the ramp's level
    assert w[:, : n // 2].abs().max().item() <= 1e-13


@pytest.mark.parametrize("n,B", [(33, 16), (110, 1)])
def test_plain_exactly_degenerate(n, B):
    G = _degenerate(B, n, seed=n)
    w, V, info = hs.herm_eigh_small_plain(G)
    _assert_eigh(G, w, V, info)
    counts = [int(((w - v).abs() < 1e-12).sum()) for v in (0.0, 1.0, 2.0)]
    assert sum(counts) == B * n


def test_plain_zero_diagonal_and_real_inputs():
    Z = torch.zeros(2, 5, 5, dtype=torch.complex128)
    w, V, info = hs.herm_eigh_small_plain(Z)
    assert info.tolist() == [0, 0] and bool((w == 0).all())
    assert torch.equal(V, torch.eye(5, dtype=V.dtype).expand(2, 5, 5))
    D = torch.diag_embed(torch.tensor([[3.0, -1.0, 2.0]], dtype=torch.complex128))
    w, V, info = hs.herm_eigh_small_plain(D)
    assert info.tolist() == [0] and w.tolist() == [[-1.0, 2.0, 3.0]]
    S = _herm(3, 12, seed=4).real.contiguous()
    w, V, info = hs.herm_eigh_small_plain(S)
    assert V.dtype == torch.float64 and w.shape == (3, 12)
    _assert_eigh(S.to(torch.complex128), w, V.to(torch.complex128), info)


def test_plain_stops_a_non_finite_matrix_at_once():
    G = _herm(3, 6, seed=10)
    G[1, 4, 2] = float("nan")
    w, V, info = hs.herm_eigh_small_plain(G)
    assert info[1].item() == -hs.MAX_SWEEPS and info[0].item() >= 0 <= info[2].item()
    _assert_eigh(G[::2], w[::2], V[::2], info[::2])


def test_plain_reads_the_lower_triangle_and_keeps_batch_axes():
    G = _herm(6, 9, seed=5)
    noisy = G + torch.triu(torch.randn(6, 9, 9, dtype=torch.complex128), 1)
    noisy = noisy + 1j * torch.diag_embed(torch.randn(6, 9, dtype=torch.float64))
    got = hs.herm_eigh_small_plain(noisy.reshape(2, 3, 9, 9))
    want = hs.herm_eigh_small_plain(G)
    assert got[0].shape == (2, 3, 9) and got[2].shape == (2, 3)
    torch.testing.assert_close(got[0].reshape(6, 9), want[0], rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", SIDES + [15, 16, 17, 64, 100])
def test_schedule_is_a_parallel_ordering(n):
    """Every sub-round pairs each of the m columns once; a sweep (m - 1
    sub-rounds) rotates every pair once; the geometry fits the kernel."""
    C, k, m = hs.geometry(n)
    assert 1 <= C <= hs.MAX_CLUSTER and m == 2 * C * k >= n and 2 * k <= 16
    assert m - 2 * C < n or C == 1  # no whole block of padding
    seen = set()
    rounds = [torch.tensor([(cols[s1], cols[s2]) for cols in members
                            for s1, s2 in (hs._local_pair(first, t, i, k) for i in range(k))])
              for first, members in hs._block_rounds(n)
              for t in range(2 * k - 1 if first else k)]
    assert len(rounds) == m - 1
    for P in rounds:
        assert P.shape == (m // 2, 2) and sorted(P.flatten().tolist()) == list(range(m))
        for p, q in P.tolist():
            seen.add((min(p, q), max(p, q)))
    assert len(seen) == m * (m - 1) // 2


def test_wrapper_checks_and_cpu_route():
    G = _herm(2, 7, seed=6)
    before = hs.herm_eigh_small.launches
    got = hs.herm_eigh_small(G)
    want = hs.herm_eigh_small_plain(G)
    assert hs.herm_eigh_small.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        hs.herm_eigh_small(torch.zeros(1, 129, 129, dtype=torch.complex128))
    with pytest.raises(ValueError):
        hs.herm_eigh_small(torch.zeros(1, 3, 4, dtype=torch.complex128))
    with pytest.raises(TypeError):
        hs.herm_eigh_small(torch.zeros(1, 3, 3, dtype=torch.complex64))
    with pytest.raises(ValueError):
        hs.herm_eigh_small(torch.zeros(1, 3, 3, dtype=torch.complex128, device="meta"))


# -- the split's functions through the plain route -------------------------

def _plain_route(monkeypatch):
    monkeypatch.setattr(linalg, "_eigh", lambda G: hs.herm_eigh_small_plain(G)[:2])


def test_inv_sqrt_through_the_plain_route_matches_lapack(monkeypatch):
    rng = np.random.default_rng(7)
    Y = rng.normal(size=(10, 300, 110)) + 1j * rng.normal(size=(10, 300, 110))
    Y = Y * np.logspace(0, -2, 110)  # condition of the Gram ~1e4
    G = torch.from_numpy(Y.conj().transpose(0, 2, 1) @ Y)
    want = linalg._hermitian_inv_sqrt(G)
    _plain_route(monkeypatch)
    got = linalg._hermitian_inv_sqrt(G)
    err = (torch.linalg.matrix_norm(got - want) / torch.linalg.matrix_norm(want)).max()
    assert err.item() <= 1e-10


def test_svd_gram_through_the_plain_route_matches_lapack(monkeypatch):
    rng = np.random.default_rng(8)
    A = rng.normal(size=(16, 200, 110)) + 1j * rng.normal(size=(16, 200, 110))
    A = torch.from_numpy(A * np.logspace(0, -3, 110))
    U, s, Vh = linalg.svd_gram(A.mT)  # wide: the Gram of the smaller side
    want = (U * s[..., None, :].to(U.dtype)) @ Vh
    _plain_route(monkeypatch)
    U, s, Vh = linalg.svd_gram(A.mT)
    got = (U * s[..., None, :].to(U.dtype)) @ Vh
    err = (torch.linalg.matrix_norm(got - want) / torch.linalg.matrix_norm(want)).max()
    assert err.item() <= 1e-10
    assert bool((s[..., 1:] <= s[..., :-1]).all())


# -- routing ----------------------------------------------------------------

def test_cpu_and_large_grams_stay_on_torch_eigh(monkeypatch):
    """On the CPU every Gram goes to torch.linalg.eigh inside
    ``linalg:eigh`` (as before the kernel), whatever its side; the kernel's
    wrapper is never called."""
    def refuse(G):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(hs, "herm_eigh_small", refuse)
    A = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 300, 140))).to(torch.complex128)
    with profiling.recording():
        linalg.svd_gram(A)                                   # side 140
        linalg.svd_gram(A[..., :110])                        # side 110
        linalg._hermitian_inv_sqrt(A[..., :12].mH @ A[..., :12])
    labels = [s.label for s in profiling.last_recording().spans]
    assert labels.count("linalg:eigh") == 3 and "linalg:eigh_small" not in labels


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, for the routing."""

    @property
    def is_cuda(self):
        return True


def _fake_kernel(calls, info=0):
    """A stand-in for the kernel's wrapper: zeros, and ``info`` per matrix."""
    def run(G):
        calls.append("small")
        return (torch.zeros(G.shape[:-1], dtype=torch.float64),
                torch.zeros(G.shape, dtype=torch.complex128),
                torch.full(G.shape[:-2], info, dtype=torch.int32))
    return run


@pytest.mark.parametrize("n,small", [(1, False), (32, False), (33, True), (110, True),
                                     (128, True), (129, False), (1000, False)])
def test_cuda_grams_route_by_side(monkeypatch, n, small):
    """On CUDA a batch of Grams of side KERNEL_MIN_SIDE..MAX_N goes to the
    kernel, inside ``linalg:eigh_small``; a smaller one (cuSOLVER's batched
    Jacobi route) or a larger one (the full splits', side 1000) to
    torch.linalg.eigh, inside ``linalg:eigh``."""
    assert linalg.KERNEL_MIN_SIDE == 33
    calls = []
    monkeypatch.setattr(hs, "herm_eigh_small", _fake_kernel(calls))
    monkeypatch.setattr(torch.linalg, "eigh", lambda G: calls.append("library") or (0, 1))
    monkeypatch.setattr(linalg, "_unchecked", threading.local())
    G = torch.zeros(linalg.KERNEL_MIN_BATCH, n, n,
                    dtype=torch.complex128).as_subclass(_CudaLike)
    with profiling.recording():
        w, V = linalg._eigh(G)
    labels = [s.label for s in profiling.last_recording().spans]
    assert calls == ["small" if small else "library"]
    assert labels == ["linalg:eigh_small" if small else "linalg:eigh"]
    if small:
        assert w.shape == G.shape[:-1] and V.shape == G.shape
        assert not w.isnan().any() and not V.isnan().any()
    else:
        assert (w, V) == (0, 1)


@pytest.mark.parametrize("shape", [(110, 110), (1, 110, 110), (2, 110, 110),
                                   (1, 2, 64, 64)])
def test_cuda_batches_below_the_crossover_stay_on_torch_eigh(monkeypatch, shape):
    """Fewer than KERNEL_MIN_BATCH matrices, whatever their side or batch
    axes, go to torch.linalg.eigh (cuSOLVER's call is faster there)."""
    assert int(np.prod(shape[:-2])) < linalg.KERNEL_MIN_BATCH
    calls = []
    monkeypatch.setattr(hs, "herm_eigh_small", _fake_kernel(calls))
    monkeypatch.setattr(torch.linalg, "eigh", lambda G: calls.append("library") or (0, 1))
    G = torch.zeros(shape, dtype=torch.complex128).as_subclass(_CudaLike)
    assert linalg._eigh(G) == (0, 1) and calls == ["library"]


def test_unconverged_matrix_is_nan_and_the_next_fetch_raises(monkeypatch):
    """A matrix the kernel reports unconverged (info < 0) comes back as
    NaN, its neighbours untouched; the thread's next fetch raises, once,
    and a fetch after a converged launch returns the values alone."""
    monkeypatch.setattr(linalg, "_unchecked", threading.local())
    B, n = linalg.KERNEL_MIN_BATCH + 1, linalg.KERNEL_MIN_SIDE
    G = torch.zeros(B, n, n, dtype=torch.complex128).as_subclass(_CudaLike)
    x = torch.tensor([3, 5]).as_subclass(_CudaLike)

    monkeypatch.setattr(hs, "herm_eigh_small", _fake_kernel([]))
    linalg._eigh(G)
    assert linalg.fetch(x).tolist() == [3, 5]
    assert linalg.fetch(x).tolist() == [3, 5]                # nothing pending

    def one_unconverged(G):
        w, V, info = _fake_kernel([])(G)
        info[1] = -hs.MAX_SWEEPS
        return w, V, info

    monkeypatch.setattr(hs, "herm_eigh_small", one_unconverged)
    w, V = linalg._eigh(G)
    assert w[1].isnan().all() and V[1].isnan().all()
    assert not w[0].isnan().any() and not V[[0, 2]].isnan().any()
    monkeypatch.setattr(hs, "herm_eigh_small", _fake_kernel([]))
    linalg._eigh(G)                                          # a later converged launch
    with pytest.raises(torch.linalg.LinAlgError, match="did not converge"):
        linalg.fetch(x)
    assert linalg.fetch(x).tolist() == [3, 5]                # raised once


def test_pending_checks_are_per_thread(monkeypatch):
    """An unconverged launch on one engine thread raises at that thread's
    fetch, not at another's."""
    monkeypatch.setattr(linalg, "_unchecked", threading.local())
    monkeypatch.setattr(hs, "herm_eigh_small", _fake_kernel([], info=-1))
    n = linalg.KERNEL_MIN_SIDE
    G = torch.zeros(linalg.KERNEL_MIN_BATCH, n, n,
                    dtype=torch.complex128).as_subclass(_CudaLike)
    x = torch.tensor([1.5]).as_subclass(_CudaLike)
    seen = []

    def other():
        seen.append(linalg.fetch(x).tolist())

    linalg._eigh(G)
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert seen == [[1.5]]
    with pytest.raises(torch.linalg.LinAlgError):
        linalg.fetch(x)


# -- the build under threads -------------------------------------------------

def test_build_load_under_threads_builds_and_loads_once(monkeypatch):
    builds, loads = [], []

    def fake_build(names):
        builds.append(tuple(names))
        time.sleep(0.05)  # long enough for the other threads to arrive
        return {n: "" for n in names}

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    got, start = [], threading.Barrier(4)

    def worker():
        start.wait(timeout=30)
        got.append(_build.load("herm_eigh_small"))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("herm_eigh_small",)] and len(loads) == 1
    assert len(got) == 4 and all(g is got[0] for g in got)


# -- on a card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 10, 16])
@pytest.mark.parametrize("n", SIDES)
def test_kernel_matches_plain_and_library_on_card(n, B):
    _card()
    if B == 8 and n != 110:
        pytest.skip("B = 8 is checked at n = 110 only")
    for make in (_herm, _gram, _degenerate):
        G = make(B, n, seed=n + B, device="cuda")
        before = hs.herm_eigh_small.launches
        w, V, info = hs.herm_eigh_small(G)
        torch.cuda.synchronize()
        assert hs.herm_eigh_small.launches == before + 1
        _assert_eigh(G, w, V, info)
        wp, _, _ = hs.herm_eigh_small_plain(G)
        scale = wp.abs().amax(-1).clamp_min(1e-300)
        assert ((w - wp).abs().amax(-1) / scale).max().item() <= TOL


@pytest.mark.cuda
def test_kernel_refusals_raise(monkeypatch):
    _card()
    with pytest.raises(ValueError):
        hs.herm_eigh_small(torch.zeros(1, 129, 129, dtype=torch.complex128, device="cuda"))
    monkeypatch.setattr(hs, "geometry", lambda n: (9, 8, 144))  # no such cluster
    with pytest.raises(RuntimeError, match="launch failed"):
        hs.herm_eigh_small(_herm(1, 110, seed=1, device="cuda"))


@pytest.mark.cuda
def test_one_rb_batch_launches_sixteen_a_randomized_pass(monkeypatch):
    """One RB batch of the production engine (d = 1000, cap 100, 10 dB, 16
    trajectories): 16 kernel launches per randomized split pass of at least
    KERNEL_MIN_BATCH trajectories (15 range finder orthonormalizations and
    the final Gram, of side 110), and every Gram torch.linalg.eigh still
    sees is a full split's (side 1000) or one of a smaller pass."""
    _card()
    from quantum_computations_tpu_torch.dv import State
    from quantum_computations_tpu_torch.gkp import db2eps
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
    from quantum_computations_tpu_torch.pipelines.rb import random_circ

    passes, library = [], []
    rsvd = linalg.randomized_truncated_svd
    eigh = torch.linalg.eigh

    def count_pass(A, k, *args, **kwargs):
        # (trajectories, Gram side) of the pass
        passes.append((int(np.prod(A.shape[:-2])), min(k + linalg.OVERSAMPLE, *A.shape[-2:])))
        return rsvd(A, k, *args, **kwargs)

    def record_eigh(G, *args, **kwargs):
        library.append(G.shape)
        return eigh(G, *args, **kwargs)

    monkeypatch.setattr(linalg, "randomized_truncated_svd", count_pass)
    monkeypatch.setattr(torch.linalg, "eigh", record_eigh)
    _, circ = random_circ(2, 8, np.random.default_rng(42))
    engine = BatchedGKP(np.linspace(-20, 20, 1000), db2eps(10.0),
                        {"rel_err": 1e-2, "max_bond_dim": 100}, adaptive=True,
                        granularity="op", device="cuda")
    before = hs.herm_eigh_small.launches
    engine.run_circuit(circ, logical_coeffs([State.ZERO] * 2), 16, rng_seed=3)
    torch.cuda.synchronize()
    on_kernel = [p for p in passes if p[0] >= linalg.KERNEL_MIN_BATCH
                 and linalg.KERNEL_MIN_SIDE <= p[1] <= hs.MAX_N]
    assert on_kernel, "the batch made no randomized split pass the kernel takes"
    assert hs.herm_eigh_small.launches - before == 16 * len(on_kernel)
    assert library and all(not linalg.KERNEL_MIN_SIDE <= s[-1] <= hs.MAX_N
                           or int(np.prod(s[:-2])) < linalg.KERNEL_MIN_BATCH
                           for s in library), library


@pytest.mark.cuda
def test_unconverged_matrix_on_card_is_nan_and_the_fetch_raises():
    """A Gram with a non-finite entry stops the kernel at once (info < 0):
    ``_eigh`` returns NaN for it alone, and the next fetch raises."""
    _card()
    G = _gram(linalg.KERNEL_MIN_BATCH, 110, seed=5, device="cuda")
    G[1, 7, 3] = float("nan")
    w, V = linalg._eigh(G)
    assert w[1].isnan().all() and not w[0].isnan().any()
    with pytest.raises(torch.linalg.LinAlgError):
        linalg.fetch(torch.ones(2, device="cuda"))
    assert linalg.fetch(torch.ones(2, device="cuda")).tolist() == [1.0, 1.0]
