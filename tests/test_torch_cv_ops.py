"""The port's CV numerics (``ops/linalg``, ``ops/theta``, ``ops/interp``)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(x64, as ``tests/conftest.py`` sets it) and the port's counterpart in
complex128 on the CPU. Tolerances:
- 1e-10 (relative to the largest magnitude) for elementwise, FFT, sinc,
  rotation and warp functions: both sides evaluate the same float64
  formulas, summed in possibly different orders (LAPACK/BLAS vs XLA);
- 1e-9 for split products and singular values: two LAPACK SVDs of the
  same matrix agree to a few ulps times the condition of the product;
- exact for kept ranks and bond caps, on spectra with a gap at the cut;
- randomized SVDs share JAX's own sketch (``sketch=``), so both run the
  same numbers; the range finders' projectors Q Q^H agree to 1e-9 (the
  JAX package perturbs its realified eigh by 1e-9 of the mean
  eigenvalue; the projector is blind to that).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from mpmath import jtheta
from scipy.interpolate import RegularGridInterpolator

from quantum_computations_tpu.ops import interp as jinterp
from quantum_computations_tpu.ops import linalg as jlinalg
from quantum_computations_tpu.ops import theta as jtheta3
from quantum_computations_tpu_torch.ops import interp, linalg, theta

RTOL = 1e-10
SPLIT_TOL = 1e-9


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _cplx(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _sketch(key, n, l):
    return np.array(jax.random.normal(key, (n, l), dtype=jnp.float64))


# ---------------------------------------------------------------------------
# theta functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps_db", [5.0, 10.0, 15.0])
def test_theta3_matches_jax_and_mpmath(eps_db):
    eps = 2.0 * np.arctanh(np.float_power(10.0, -eps_db / 10.0) / 2.0)
    tau = 1j * np.tanh(eps) / 2
    zs = np.linspace(-4.0, 4.0, 17)
    got = theta.theta3(_t(zs), tau).numpy()
    _close(got, theta3_jax := np.asarray(jtheta3.theta3(jnp.asarray(zs), tau)))
    want = np.array([complex(jtheta(3, np.pi * z, np.exp(1j * np.pi * tau))) for z in zs])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert theta3_jax.dtype == np.complex128


def test_modified_theta_and_gaussians_match_jax():
    zs = np.linspace(-3, 3, 11)
    for a, b, tau in ((0.0, 0.5, 0.08j), (0.3, 0.0, 0.2j), (0.0, 0.0, 0.05j)):
        _close(theta.modified_theta(a, b, _t(zs), tau).numpy(),
               jtheta3.modified_theta(a, b, jnp.asarray(zs), tau))
    s = np.linspace(-8, 8, 33)
    _close(theta.gaussians(_t(s), 0.1).numpy(), jtheta3.gaussians(jnp.asarray(s), 0.1))


# ---------------------------------------------------------------------------
# interpolation, Fourier transforms, warps
# ---------------------------------------------------------------------------

def test_whittaker_shannon_matches_jax():
    rng = np.random.default_rng(0)
    xs = np.linspace(-10, 10, 101)
    ys = _cplx(rng, 3, 101, 2)
    new_xs = xs + 0.37
    _close(interp.whittaker_shannon(_t(xs), _t(ys), _t(new_xs), axis=1).numpy(),
           jinterp.whittaker_shannon(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(new_xs), axis=1))
    f = lambda x: np.exp(-x**2 / 2) * np.cos(2 * x)  # noqa: E731
    got = interp.interpolate(_t(xs), _t(f(xs)), _t(xs + 0.05)).numpy()
    np.testing.assert_allclose(got, f(xs + 0.05), atol=1e-6)


@pytest.mark.parametrize("theta_", [0.3, np.pi / 2, 2.0, -1.1])
def test_rotation_matches_jax(theta_):
    rng = np.random.default_rng(1)
    qs = np.linspace(-6, 6, 96)
    t = _cplx(rng, 2, 96, 3)
    _close(interp.rotation(_t(qs), _t(t), theta_, axis=1).numpy(),
           jinterp.rotation(jnp.asarray(qs), jnp.asarray(t), theta_, axis=1))
    new_qs = qs[::2] + 0.1
    _close(interp.rotation(_t(qs), _t(t[0, :, 0]), theta_, new_qs=_t(new_qs)).numpy(),
           jinterp.rotation(jnp.asarray(qs), jnp.asarray(t[0, :, 0]), theta_,
                            new_qs=jnp.asarray(new_qs)))


@pytest.mark.parametrize("n", [128, 129])
def test_cft_icft_fourier_match_jax(n):
    rng = np.random.default_rng(n)
    qs = np.linspace(-12, 12, n)
    t = _cplx(rng, 2, n, 2)
    for fn in ("CFT", "iCFT"):
        ps_t, f_t = getattr(interp, fn)(_t(qs), _t(t), axis=1)
        ps_j, f_j = getattr(jinterp, fn)(jnp.asarray(qs), jnp.asarray(t), axis=1)
        _close(ps_t.numpy(), ps_j)
        _close(f_t.numpy(), f_j)
    for inv in (False, True):
        _close(interp.fourier(_t(qs), _t(t), axis=1, inv=inv).numpy(),
               jinterp.fourier(jnp.asarray(qs), jnp.asarray(t), axis=1, inv=inv))
    ps = np.linspace(-20, 20, 50)  # evaluated past the band: the periodic wrap
    _close(interp.fourier(_t(qs), _t(t[0, :, 0]), ps=_t(ps)).numpy(),
           jinterp.fourier(jnp.asarray(qs), jnp.asarray(t[0, :, 0]), ps=jnp.asarray(ps)))


def test_fourier_gate_on_gaussian_and_cft_kick():
    qs = np.linspace(-12, 12, 301)
    psi = np.pi**-0.25 * np.exp(-qs**2 / 2)
    np.testing.assert_allclose(interp.fourier(_t(qs), _t(psi.astype(complex))).numpy(),
                               psi, atol=1e-6)
    ps, f = interp.CFT(_t(qs), _t(psi * np.exp(1.5j * qs)))
    ps, f = ps.numpy(), f.numpy()
    assert abs(ps[np.argmax(np.abs(f))] - 1.5) < 0.1
    np.testing.assert_allclose(np.sum(np.abs(f) ** 2) * (ps[1] - ps[0]),
                               np.sum(np.abs(psi) ** 2) * (qs[1] - qs[0]), rtol=1e-6)


def test_wigner_matches_jax():
    qs = np.linspace(-6, 6, 64)
    psi = (np.pi**-0.25 * np.exp(-(qs - 0.5) ** 2 / 2) * np.exp(0.7j * qs)).astype(complex)
    ps_t, w_t = interp.wigner(_t(qs), _t(psi))
    ps_j, w_j = jinterp.wigner(jnp.asarray(qs), jnp.asarray(psi))
    _close(w_t.numpy(), w_j)
    _close(ps_t.numpy(), ps_j)


def test_warp_2d_matches_scipy_rgi_and_jax():
    rng = np.random.default_rng(1)
    d = 40
    qs = np.linspace(-3, 3, d)
    tensor = _cplx(rng, 2, d, d, 3)
    angle = 0.3
    x, y = np.meshgrid(qs, qs, indexing="ij")
    xr, yr = np.cos(angle) * x + np.sin(angle) * y, -np.sin(angle) * x + np.cos(angle) * y

    got = interp.rotate_2d(_t(qs), _t(tensor), angle).numpy()
    want = np.empty_like(tensor)
    for a in range(2):
        for b in range(3):
            rgi = RegularGridInterpolator((qs, qs), tensor[a, :, :, b], method="linear",
                                          bounds_error=False, fill_value=0)
            want[a, :, :, b] = rgi((xr, yr))
    np.testing.assert_allclose(got, want, atol=1e-10)
    _close(got, jinterp.rotate_2d(jnp.asarray(qs), jnp.asarray(tensor), angle))
    for control_left in (True, False):
        _close(interp.shear_2d(_t(qs), _t(tensor), 0.7, control_left).numpy(),
               jinterp.shear_2d(jnp.asarray(qs), jnp.asarray(tensor), 0.7, control_left))


def test_warp_2d_chunks_over_the_leading_axis():
    rng = np.random.default_rng(2)
    qs = np.linspace(-3, 3, 16)
    tensor = _cplx(rng, 6, 16, 16, 2)
    x_src, y_src = interp.rotation_maps(_t(qs), 0.4)
    whole = interp.warp_2d(_t(qs), _t(tensor), x_src, y_src)
    chunked = interp.warp_2d(_t(qs), _t(tensor), x_src, y_src, chunk_elements=16 * 16 * 2 * 2)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    _close(whole.numpy(), jinterp.warp_2d(jnp.asarray(qs), jnp.asarray(tensor),
                                          *jinterp.rotation_maps(jnp.asarray(qs), 0.4)))


@pytest.mark.parametrize("params", [
    ("rot", 0.6), ("rot", -np.pi / 4), ("shear", 0.8, True), ("shear", -1.3, False),
    ("cz", 0.9), ("swap",), ("id",)])
def test_affine_warp_matches_jax(params):
    rng = np.random.default_rng(3)
    qs = np.linspace(-8, 8, 64)
    t = _cplx(rng, 2, 64, 64, 3)
    _close(interp.affine_warp(_t(qs), _t(t), params).numpy(),
           jinterp.affine_warp(jnp.asarray(qs), jnp.asarray(t), params))


def test_shear_and_rotate_fft_on_other_axes_match_jax():
    rng = np.random.default_rng(4)
    qs = np.linspace(-8, 8, 48)
    t = _cplx(rng, 48, 3, 48)
    _close(interp.shear_fft(_t(qs), _t(t), 0.4, 2, 0).numpy(),
           jinterp.shear_fft(jnp.asarray(qs), jnp.asarray(t), 0.4, 2, 0))
    _close(interp.rotate_fft(_t(qs), _t(t), 1.1, 0, 2).numpy(),
           jinterp.rotate_fft(jnp.asarray(qs), jnp.asarray(t), 1.1, 0, 2))


def test_interp_keeps_complex64():
    qs = np.linspace(-5, 5, 32)
    t = torch.ones(1, 32, 32, 1, dtype=torch.complex64)
    for params in (("rot", 0.3), ("shear", 0.5, True), ("cz", 1.0)):
        assert interp.affine_warp(_t(qs), t, params).dtype == torch.complex64
    assert interp.fourier(_t(qs), t[0, :, :, 0], axis=1).dtype == torch.complex64
    assert interp.rotation(_t(qs), t[0, :, :, 0], 0.5, axis=1).dtype == torch.complex64


# ---------------------------------------------------------------------------
# SVD, truncation, randomized SVD
# ---------------------------------------------------------------------------

def _svd_via_eigh(A: torch.Tensor):
    """The JAX package's realified-Gram SVD (its TPU route, which the port
    does not take) written in torch, to hold the translation of its
    numerics against the JAX function."""
    m, n = A.shape
    if m < n:
        U, s, Vh = _svd_via_eigh(A.mH)
        return Vh.mH.resolve_conj(), s, U.mH.resolve_conj()
    B = A.mH @ A
    split = 1e-4 if B.real.dtype == torch.float32 else 1e-6
    scale = torch.trace(B).real / max(n, 1)
    B = B + (split * scale / max(n, 1)) * torch.diag(
        torch.arange(n, dtype=B.real.dtype, device=B.device))
    M = torch.cat([torch.cat([B.real, -B.imag], 1),
                   torch.cat([B.imag, B.real], 1)], 0)
    w, U2 = torch.linalg.eigh(M)  # ascending, eigenvalues doubled
    U2 = U2.flip(1)
    V = torch.complex(U2[:n, ::2], U2[n:, ::2]).to(A.dtype)  # one per pair
    norms = torch.linalg.vector_norm(V, dim=0)
    V = V / torch.where(norms > 0, norms, torch.ones_like(norms))[None, :]
    AV = A @ V
    s = torch.linalg.vector_norm(AV, dim=0)
    U = AV / torch.where(s > 0, s, torch.ones_like(s))[None, :]
    return U, s, V.mH.resolve_conj()


@pytest.mark.parametrize("shape", [(40, 12), (12, 50), (30, 30)])
def test_svd_compat_and_svd_via_eigh_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    A = _cplx(rng, *shape)
    s_ref = np.linalg.svd(A, compute_uv=False)
    for fn_t, fn_j in ((linalg.svd_compat, jlinalg.svd_compat),
                       (_svd_via_eigh, jlinalg.svd_via_eigh)):
        U, s, Vh = (x.numpy() for x in fn_t(_t(A)))
        Uj, sj, Vhj = (np.asarray(x) for x in fn_j(jnp.asarray(A)))
        _close(s, sj, SPLIT_TOL)
        _close((U * s) @ Vh, (Uj * sj) @ Vhj, SPLIT_TOL)
        np.testing.assert_allclose(s, s_ref, rtol=1e-6, atol=s_ref.max() * 1e-7)


@pytest.mark.parametrize("shape", [(300, 40), (40, 300), (100, 100)])
def test_svd_gram_matches_lapack_and_jax(shape):
    """The CUDA route of ``svd_compat``, run here on the CPU: float64 Gram
    eigh. Singular values over six decades (the route's error is about
    1e-16 s_max^2 / s_i) and the truncated products agree with LAPACK (the
    JAX package's ``svd_compat``) to 1e-9; from complex64 input, to float32
    precision (1e-6)."""
    rng = np.random.default_rng(shape[0])
    k = min(shape)
    q1 = np.linalg.qr(_cplx(rng, shape[0], k))[0]
    q2 = np.linalg.qr(_cplx(rng, shape[1], k))[0]
    A = q1 @ np.diag(np.logspace(0, -6, k)) @ q2.conj().T
    U, s, Vh = (x.numpy() for x in linalg.svd_gram(_t(A)))
    Uj, sj, Vhj = (np.asarray(x) for x in jlinalg.svd_compat(jnp.asarray(A)))
    _close(s, sj, SPLIT_TOL)
    for r in (5, 20):
        _close((U[:, :r] * s[:r]) @ Vh[:r], (Uj[:, :r] * sj[:r]) @ Vhj[:r], SPLIT_TOL)
    U32, s32, Vh32 = linalg.svd_gram(_t(A).to(torch.complex64))
    assert U32.dtype == Vh32.dtype == torch.complex64 and s32.dtype == torch.float32
    _close(s32.numpy(), sj, 1e-6)
    _close(((U32[:, :20] * s32[:20]) @ Vh32[:20]).numpy(), (Uj[:, :20] * sj[:20]) @ Vhj[:20], 1e-6)


def test_svd_compat_is_lapack_on_the_cpu():
    A = _t(_cplx(np.random.default_rng(1), 30, 20))
    for a, b in zip(linalg.svd_compat(A), torch.linalg.svd(A, full_matrices=False)):
        assert torch.equal(a, b)


def test_svd_via_eigh_degenerate_spectrum_matches_jax():
    rng = np.random.default_rng(7)
    q1, _ = np.linalg.qr(_cplx(rng, 6, 6))
    q2, _ = np.linalg.qr(_cplx(rng, 6, 6))
    A = q1 @ np.diag([3.0, 3.0, 3.0, 1.0, 1.0, 1e-3]) @ q2.conj().T
    U, s, Vh = (x.numpy() for x in _svd_via_eigh(_t(A)))
    _, sj, _ = jlinalg.svd_via_eigh(jnp.asarray(A))
    _close(s, sj, SPLIT_TOL)
    np.testing.assert_allclose((U * s) @ Vh, A, atol=3e-6)


def test_bucket_and_trim_split():
    assert [linalg.bucket(n) for n in (0, 1, 2, 3, 5, 64, 65, 100)] == \
           [jlinalg.bucket(n) for n in (0, 1, 2, 3, 5, 64, 65, 100)]
    m1, m2 = torch.ones(4, 3, 16), torch.ones(16, 5)
    a, b = linalg.trim_split(m1, m2, torch.tensor(5))
    assert a.shape == (4, 3, 8) and b.shape == (8, 5)
    a, b = linalg.trim_split(m1, m2, 0)
    assert a.shape == (4, 3, 1) and b.shape == (1, 5)


@pytest.mark.parametrize("max_bond_dim,abs_err,rel_err", [
    (25, 0.0, 0.05), (8, 0.0, 0.05), (30, 0.5, 1e-12), (30, 0.0, 1e-12)])
def test_truncation_rank_mask_exact(max_bond_dim, abs_err, rel_err):
    s = np.sort(np.random.default_rng(3).uniform(0.1, 5.0, 30))[::-1].copy()
    rank, mask = linalg.truncation_rank_mask(_t(s), max_bond_dim, abs_err, rel_err)
    rj, mj = jlinalg.truncation_rank_mask(jnp.asarray(s), max_bond_dim, abs_err, rel_err)
    assert int(rank) == int(rj)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mj))
    allowed = max(abs_err, s.sum() * rel_err)
    assert int(rank) == min(int(np.sum(np.flip(s).cumsum() > allowed)), max_bond_dim)


def test_truncation_keeps_strict_inequality_at_the_cut():
    s = np.array([4.0, 3.0, 2.0, 1.0])  # rel_err 0.1: allowed = 1.0 = tail[3]
    rank, _ = linalg.truncation_rank_mask(_t(s), 10, 0.0, 0.1)
    rj, _ = jlinalg.truncation_rank_mask(jnp.asarray(s), 10, 0.0, 0.1)
    assert int(rank) == int(rj) == 3


@pytest.mark.parametrize("shape,left,right,mbd", [
    ((3, 8, 8, 2), (0, 1), (2, 3), None),
    ((3, 8, 8, 2), (0, 1), (2, 3), 5),
    ((2, 6, 6, 2), (0, 2), (1, 3), 3),
    ((4, 16, 16, 4), (0, 1), (2, 3), 100)])
def test_tensor_svd_full_path_matches_jax(shape, left, right, mbd):
    rng = np.random.default_rng(len(shape) + (mbd or 0))
    t = _cplx(rng, *shape)
    m1, m2, rank = linalg.tensor_svd(_t(t), left, right, max_bond_dim=mbd, rel_err=1e-2)
    j1, j2, rj = jlinalg.tensor_svd(jnp.asarray(t), left, right, max_bond_dim=mbd,
                                    rel_err=1e-2, key=jax.random.PRNGKey(0))
    assert int(rank) == int(rj)
    assert m1.shape == j1.shape and m2.shape == j2.shape
    r = len(left)
    _close(torch.tensordot(m1, m2, dims=1).numpy(), np.tensordot(j1, j2, axes=1), SPLIT_TOL)
    m1 = m1.reshape(-1, m1.shape[-1]).numpy()
    assert np.all(m1[:, int(rank):] == 0)
    assert r == len(left)


def test_tensor_svd_reconstructs_and_raises_on_bad_indices():
    rng = np.random.default_rng(2)
    t = _cplx(rng, 3, 8, 8, 2)
    m1, m2, _ = linalg.tensor_svd(_t(t), (0, 1), (2, 3))
    np.testing.assert_allclose(torch.tensordot(m1, m2, dims=1).numpy(), t, atol=1e-10)
    with pytest.raises(IndexError):
        linalg.tensor_svd(_t(t), (0, 1), (1, 3))


def test_randomized_range_finder_with_shared_sketch():
    rng = np.random.default_rng(5)
    A = _cplx(rng, 120, 30) @ _cplx(rng, 30, 90)
    key = jax.random.PRNGKey(3)
    l = 20  # below the rank (30), so Q is orthonormal
    Qj = np.asarray(jlinalg.randomized_range_finder(jnp.asarray(A), l, 4, key))
    Qt = linalg.randomized_range_finder(_t(A), l, 4, sketch=_sketch(key, 90, l)).numpy()
    _close(Qt @ Qt.conj().T, Qj @ Qj.conj().T, SPLIT_TOL)
    np.testing.assert_allclose(Qt.conj().T @ Qt, np.eye(l), atol=1e-12)


@pytest.mark.parametrize("shape,k", [((200, 150), 40), ((60, 300), 5)])
def test_randomized_truncated_svd_with_shared_sketch(shape, k):
    """The power-iteration count (7 if k < 0.1 min(shape), else 4) and the
    transpose of a wide matrix must match for the shared sketch to fit."""
    rng = np.random.default_rng(k)
    A = _cplx(rng, shape[0], 45) @ _cplx(rng, 45, shape[1])
    key = jax.random.PRNGKey(k)
    Uj, sj, Vhj = (np.asarray(x) for x in jlinalg.randomized_truncated_svd(jnp.asarray(A), k, key))
    n = min(shape)  # rows of the sketch: the transposed matrix's columns
    U, s, Vh = (x.numpy() for x in linalg.randomized_truncated_svd(
        _t(A), k, sketch=_sketch(key, n, min(k + linalg.OVERSAMPLE, n))))
    _close(s, sj, SPLIT_TOL)
    _close((U * s) @ Vh, (Uj * sj) @ Vhj, SPLIT_TOL)
    assert U.shape == Uj.shape and Vh.shape == Vhj.shape


def test_randomized_svd_close_to_exact_from_a_generator():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(200, 40)) @ rng.normal(size=(40, 150))
    U, s, Vh = linalg.randomized_truncated_svd(_t(A), 40, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(A, compute_uv=False)[:40], rtol=1e-6)
    with pytest.raises(ValueError):
        linalg.randomized_truncated_svd(_t(A), 10)


def test_tensor_svd_randomized_path_with_shared_sketch(monkeypatch):
    """max_bond_dim * 10 < full_rank picks the randomized path in both."""
    rng = np.random.default_rng(9)
    t = _cplx(rng, 2, 40, 40, 2)
    key = jax.random.PRNGKey(11)
    j1, j2, rj = jlinalg.tensor_svd(jnp.asarray(t), (0, 1), (2, 3), max_bond_dim=6,
                                    rel_err=1e-3, key=key)
    sketches = [_sketch(key, 80, 16)]

    def replay(n, l, generator, like):
        o = sketches.pop(0)
        assert o.shape == (n, l)
        return torch.from_numpy(o).to(like.dtype)

    monkeypatch.setattr(linalg, "_gaussian_sketch", replay)
    m1, m2, rank = linalg.tensor_svd(_t(t), (0, 1), (2, 3), max_bond_dim=6, rel_err=1e-3,
                                     generator=torch.Generator())
    assert not sketches and int(rank) == int(rj) and m1.shape == j1.shape
    _close(torch.tensordot(m1, m2, dims=1).numpy(), np.tensordot(j1, j2, axes=1), SPLIT_TOL)


def test_orthonormalize_and_inverse_sqrt():
    rng = np.random.default_rng(12)
    Y = _cplx(rng, 50, 8)
    Q = linalg.orthonormalize(_t(Y)).numpy()
    Qj = np.asarray(jlinalg.orthonormalize(jnp.asarray(Y)))
    _close(Q @ Q.conj().T, Qj @ Qj.conj().T, SPLIT_TOL)
    np.testing.assert_allclose(Q.conj().T @ Q, np.eye(8), atol=1e-12)
    G = Y.conj().T @ Y
    X = linalg._hermitian_inv_sqrt(_t(G)).numpy()
    np.testing.assert_allclose(X @ G @ X, np.eye(8), atol=1e-10)
