"""The port's slab-window kernel module against the JAX Pallas kernel.

``slab_matmul_plain`` (and the wrapper on CPU tensors, which uses it) is
held against ``pallas_kernels.slab_matmul`` run in interpret mode, as the
JAX package's own tests run it. Tolerance: float32 planes, |x| ~ 1 and a
unitary window, so each output is a sum of 2d float32 products taken in
another order than XLA's: atol 2e-6 (d = 128 sums 256 terms of magnitude
<= 1, whose rounding stays ~1e-6).

The CUDA kernel has no CPU mode; ``test_kernel_matches_plain_on_card``
(marker ``cuda``) holds it against the plain version on a CUDA device and
skips without one. This file imports JAX only inside the JAX-side tests, so
on a machine without JAX the card tests run with
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
