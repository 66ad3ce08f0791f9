"""The port's window fusion (``dv/fusion.py``) against the JAX package's.

The host-side planners are numpy in both packages, so their outputs must
be exactly equal. ``apply_window_split`` is torch in the port and XLA in
the JAX package: float32 planes, tolerance atol 2e-6 per amplitude
(unit-norm state, unitary window of up to 2^7 columns).
"""

import numpy as np
import pytest
import torch

from quantum_computations_tpu.dv import fusion as jfusion
from quantum_computations_tpu_torch.dv import fusion as tfusion

ATOL = 2e-6


def _rand_u(rng, k):
    d = 1 << k
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, _ = np.linalg.qr(a)
    return q


def _rand_gates(rng, n_qubits, n_gates, max_k=3):
    gates = []
    for _ in range(n_gates):
        k = int(rng.integers(1, max_k + 1))
        tgts = tuple(int(t) for t in rng.choice(n_qubits, size=k, replace=False))
        gates.append((_rand_u(rng, k), tgts))
    return gates


def _assert_windows_equal(got, want):
    assert len(got) == len(want)
    for (gu, gt), (wu, wt) in zip(got, want):
        assert gt == wt
        np.testing.assert_array_equal(gu, wu)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_bits", [3, 7])
def test_fuse_windows_identical(seed, max_bits):
    rng = np.random.default_rng(seed)
    gates = _rand_gates(rng, 10, 30)
    _assert_windows_equal(tfusion.fuse_windows(gates, max_bits=max_bits),
                          jfusion.fuse_windows(gates, max_bits=max_bits))


@pytest.mark.parametrize("seed", range(3))
def test_merge_adjacent_windows_identical(seed):
    rng = np.random.default_rng(100 + seed)
    windows = [(_rand_u(rng, len(t)), t) for _, t in
               _rand_gates(rng, 8, 12, max_k=2)]
    windows = [(u, tuple(sorted(t))) for u, t in windows]
    for max_bits in (3, 4, 7):
        _assert_windows_equal(
            tfusion.merge_adjacent_windows(windows, max_bits=max_bits),
            jfusion.merge_adjacent_windows(windows, max_bits=max_bits))


def test_np_expand_and_grouped_view_identical():
    rng = np.random.default_rng(7)
    for _ in range(40):
        k = int(rng.integers(1, 8))
        g = int(rng.integers(1, k + 1))
        positions = [int(p) for p in rng.choice(k, size=g, replace=False)]
        gate = _rand_u(rng, g)
        np.testing.assert_array_equal(tfusion._np_expand(gate, k, positions),
                                      jfusion._np_expand(gate, k, positions))
        N = int(rng.integers(k, 31))
        tgts = tuple(sorted(int(t) for t in rng.choice(N, size=g, replace=False)))
        assert tfusion._grouped_view(N, tgts) == jfusion._grouped_view(N, tgts)
        shape, taxes = tfusion._grouped_view(N, tgts)
        assert (tfusion._window_subscripts(len(shape), taxes)
                == jfusion._window_subscripts(len(shape), taxes))


@pytest.mark.parametrize("targets", [(7, 8, 9), (3, 4, 5, 6, 7, 8, 9),
                                     (0, 4, 9), (1, 2, 6), (5,)])
def test_apply_window_split_matches_jax(targets):
    """Slab fast path (trailing targets) and scattered grouped einsum."""
    import jax.numpy as jnp

    N = 10
    rng = np.random.default_rng(len(targets) * 13 + targets[0])
    psi = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    psi /= np.linalg.norm(psi)
    re = psi.real.astype(np.float32)
    im = psi.imag.astype(np.float32)
    u = _rand_u(rng, len(targets))
    ur = u.real.astype(np.float32)
    ui = u.imag.astype(np.float32)
    want = jfusion.apply_window_split(jnp.asarray(re), jnp.asarray(im),
                                      jnp.asarray(ur), jnp.asarray(ui),
                                      targets, N)
    got = tfusion.apply_window_split(torch.from_numpy(re), torch.from_numpy(im),
                                     torch.from_numpy(ur), torch.from_numpy(ui),
                                     targets, N)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
