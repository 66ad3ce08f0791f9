"""The port's slab-window kernel module against the JAX Pallas kernel.

``slab_matmul_plain`` (and the wrapper on CPU tensors, which uses it) is
held against ``pallas_kernels.slab_matmul`` run in interpret mode, as the
JAX package's own tests run it. Tolerance: float32 planes, |x| ~ 1 and a
unitary window, so each output is a sum of 2d float32 products taken in
another order than XLA's: atol 2e-6 (d = 128 sums 256 terms of magnitude
<= 1, whose rounding stays ~1e-6).

The CUDA kernel has no CPU mode. Its tensor-core path (d >= 64) is
modelled here in numpy: the 3xTF32 split (``cvt.rna.tf32.f32``: 10
mantissa bits, round to nearest, ties away; the small part truncated, as
the tensor cores read it), B staged and read back as the kernel's wgmma
descriptors address it, and the tensor cores' truncating sums, held
against the plain version at the kernel's own bound, 1e-5 x max|plain|;
one TF32 pass fails that bound. ``test_kernel_matches_plain_on_card`` and
``test_tensor_cores_six_decades_on_card`` (marker ``cuda``) hold the kernel
against the plain version on a CUDA device and skip without one. This
file imports JAX only inside the JAX-side tests, so on a machine without
JAX the card tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_slab_kernel.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.ops import _build, slab_kernels as sk

ATOL = 2e-6


def _inputs(d, R, seed):
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=R * d).astype(np.float32)
    xi = rng.normal(size=R * d).astype(np.float32)
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    w, _ = np.linalg.qr(a)
    wt = w.T
    return (xr, xi, np.ascontiguousarray(wt.real, np.float32),
            np.ascontiguousarray(wt.imag, np.float32))


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("d", [2, 16, 128])
@pytest.mark.parametrize("R", [1, 8, 64, 4096])
def test_plain_matches_pallas_interpret(d, R):
    import jax.numpy as jnp

    from quantum_computations_tpu.ops import pallas_kernels as pk

    xr, xi, wtr, wti = _inputs(d, R, seed=d * 7 + R)
    want_r, want_i = pk.slab_matmul(jnp.asarray(xr), jnp.asarray(xi),
                                    jnp.asarray(wtr), jnp.asarray(wti), d,
                                    interpret=True)
    got_r, got_i = sk.slab_matmul_plain(*_t(xr, xi, wtr, wti))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=ATOL)


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest, ties
    away from zero (add half an ulp to the magnitude bits, truncate)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """big = tf32(x) to nearest; small = x - big, which the tensor cores
    read truncated to TF32 (the top 19 bits)."""
    big = _tf32(x)
    small = (x - big).astype(np.float32).view(np.uint32)
    return big, (small & np.uint32(0xFFFFE000)).view(np.float32)


def _rz_sum(acc, prod):
    """acc + prod as the tensor cores add a product into an FP32
    accumulator: exact, then truncated (rounded toward zero)."""
    exact = acc.astype(np.float64) + prod
    d = exact.astype(np.float32)
    over = np.abs(d) > np.abs(exact)
    d[over] = np.nextafter(d[over], np.float32(0))
    return d


def _tc_kernel_model(xr, xi, wtr, wti, passes=3):
    """The tensor-core kernel (d >= 64) in numpy. Each CTA of a cluster
    stages its B words as the kernel does (k-permuted 8 x 16-byte core
    matrices of [-Wt_im | Wt_re | Wt_im] for its half of the columns, TF32
    big then small) and reads them back through the wgmma descriptor
    (core matrices 128 B apart along K, 256 B along N). Per 64 rows and
    4 16-column k-blocks, 24 m64nNk8 products go into a fresh fragment with
    the tensor cores' truncating sum (small.big and big.small, then
    big.big; ``passes=1`` keeps big.big only), which is then added to the
    running sum. Rows need not fill the last tile."""
    D = wtr.shape[0]
    H, KB, KQ = D // 2, D // 16, 4            # KQ k-blocks per fragment
    step = (3 * H // 8) * 2 * 32              # words of one k-step
    words = np.arange((D // 8) * step)
    s, cm = words // step, (words % step) // 32
    r, el = (words % 32) // 4, words % 4
    k = 16 * (s // 2) + 4 * el + 2 * (cm % 2) + s % 2
    c = 8 * (cm // 2) + r
    R = xr.size // D
    rows = -(-R // 64) * 64
    x = [np.zeros((rows, D), np.float32) for _ in range(2)]
    x[0][:R], x[1][:R] = xr.reshape(R, D), xi.reshape(R, D)
    out = [np.zeros((rows, D), np.float32) for _ in range(2)]
    kk, nn = np.meshgrid(np.arange(8), np.arange(2 * H), indexing="ij")
    b_off = (nn // 8) * 64 + (kk // 4) * 32 + (nn % 8) * 4 + kk % 4
    for rank in (0, 1):
        n = rank * H + c % H
        big, small = _split(np.where(c < H, -wti[k, n],
                                     np.where(c < 2 * H, wtr[k, n],
                                              wti[k, n])).astype(np.float32))
        for row0 in range(0, rows, 64):
            acc = np.zeros((64, 2 * H), np.float32)
            for b in range(0, 2 * KB, KQ):
                src = x[b >= KB][row0:row0 + 64]
                start = 2 * (b % KB) * step + (0 if b >= KB else H // 8 * 64)
                a, bb = [], []
                for ks in range(2 * KQ):  # k-step: block b + ks // 2, j = ks % 2
                    cols = 16 * (b % KB + ks // 2) + ks % 2 + \
                        np.r_[0, 4, 8, 12, 2, 6, 10, 14]
                    a.append(_split(src[:, cols]))
                    at = start + ks * step + b_off
                    bb.append((big[at], small[at]))
                part = np.zeros((64, 2 * H), np.float32)
                lo = [(a[ks][1], bb[ks][0]) if t == 0 else (a[ks][0], bb[ks][1])
                      for ks in range(2 * KQ) for t in range(2)]
                for am, bm in lo * (passes == 3) + \
                        [(a[ks][0], bb[ks][0]) for ks in range(2 * KQ)]:
                    part = _rz_sum(part, am.astype(np.float64) @ bm)
                acc += part
            out[0][row0:row0 + 64, rank * H:rank * H + H] = acc[:, :H]
            out[1][row0:row0 + 64, rank * H:rank * H + H] = acc[:, H:]
    return out[0][:R].reshape(-1), out[1][:R].reshape(-1)


@pytest.mark.parametrize("d,R,passes", [(128, 64, 3), (128, 64, 1),
                                        (64, 100, 3)])
def test_tensor_core_model_matches_plain(d, R, passes):
    """3xTF32 with the kernel's fragments is within the kernel's bound,
    1e-5 x max|plain|, of the plain version at d = 128 (random unitary
    window, unit-normal planes) and on a ragged last tile; one TF32 pass
    is not, so the model tells the two apart."""
    xr, xi, wtr, wti = _inputs(d, R, seed=R + d)
    want = sk.slab_matmul_plain(*_t(xr, xi, wtr, wti))
    got = _tc_kernel_model(xr, xi, wtr, wti, passes)
    scale = max(float(w.abs().max()) for w in want)
    err = max(float(np.abs(g - w.numpy()).max()) for g, w in zip(got, want))
    if passes == 3:
        assert err <= 1e-5 * scale
    else:
        assert err > 1e-5 * scale


def test_wrapper_on_cpu_uses_plain_and_counts_no_launch():
    xr, xi, wtr, wti = _t(*_inputs(16, 32, seed=3))
    before = sk.slab_matmul.launches
    got = sk.slab_matmul(xr, xi, wtr, wti)
    want = sk.slab_matmul_plain(xr, xi, wtr, wti)
    assert sk.slab_matmul.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "window_shape", "d_not_pow2",
                                 "ragged_rows", "plane_mismatch",
                                 "noncontiguous", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    xr, xi, wtr, wti = _t(*_inputs(8, 16, seed=5))
    if bad == "dtype":
        xr = xr.double()
    elif bad == "window_shape":
        wtr = wtr[:, :4].contiguous()
    elif bad == "d_not_pow2":
        wtr = torch.zeros(6, 6)
        wti = torch.zeros(6, 6)
    elif bad == "ragged_rows":
        xr, xi = xr[:-3].contiguous(), xi[:-3].contiguous()
    elif bad == "plane_mismatch":
        xi = xi[:64].contiguous()
    elif bad == "noncontiguous":
        xr = torch.stack([xr, xr], 1)[:, 0]
    elif bad == "device":
        xr, xi, wtr, wti = (t.to("meta") for t in (xr, xi, wtr, wti))
    with pytest.raises((ValueError, TypeError)):
        sk.slab_matmul(xr, xi, wtr, wti)


def test_modules_import_without_nvcc_or_cuda():
    """The kernel modules import (and the CPU path runs) with no nvcc and no
    CUDA: the build happens at the first launch on a CUDA tensor."""
    code = ("import os, shutil, torch\n"
            "from quantum_computations_tpu_torch.ops import _build, "
            "slab_kernels\n"
            "x = torch.ones(8)\n"
            "slab_kernels.slab_matmul(x, x.clone(), torch.eye(4), "
            "torch.zeros(4, 4))\n")
    env = dict(os.environ, PATH="", CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_keys_on_source():
    p = _build.library_path("slab_matmul")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("libslab_matmul-") and p.suffix == ".so"
    assert _build.library_path("slab_matmul") == p  # stable across calls


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8, 16, 32, 64, 128])
def test_kernel_matches_plain_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for R in (1, 3, 1000, 1 << 14):
        xr, xi, wtr, wti = (t.cuda() for t in _t(*_inputs(d, R, seed=R + d)))
        want = sk.slab_matmul_plain(xr, xi, wtr, wti)
        ptr = xr.data_ptr()
        before = sk.slab_matmul.launches
        got = sk.slab_matmul(xr, xi, wtr, wti)
        torch.cuda.synchronize()
        assert got[0].data_ptr() == ptr  # in place
        assert sk.slab_matmul.launches == before + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_cores_six_decades_on_card(d):
    """The 3xTF32 path on inputs whose magnitudes span six decades
    (10^-3..10^3 per element): each row within 1e-5 x its own max|plain|,
    so the split keeps float32's relative precision at every scale; and
    the C dispatcher reports the tensor-core kernel for d >= 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    R = 4096 + 7
    xr, xi, wtr, wti = _inputs(d, R, seed=d + 11)
    rng = np.random.default_rng(d)
    xr = xr * 10.0 ** rng.uniform(-3, 3, xr.size).astype(np.float32)
    xi = xi * 10.0 ** rng.uniform(-3, 3, xi.size).astype(np.float32)
    xr, xi, wtr, wti = (t.cuda() for t in _t(xr, xi, wtr, wti))
    want = sk.slab_matmul_plain(xr, xi, wtr, wti)
    launches = sk.slab_matmul.tensor_core_launches
    got = sk.slab_matmul(xr, xi, wtr, wti)
    torch.cuda.synchronize()
    assert sk.slab_matmul.tensor_core_launches == launches + 1
    for g, w in zip(got, want):
        g, w = g.view(R, d), w.view(R, d)
        row_max = w.abs().amax(dim=1, keepdim=True)
        assert bool(((g - w).abs() <= 1e-5 * row_max).all())
