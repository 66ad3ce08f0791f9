"""State-vector kernels of the port: counterpart of
``quantum_computations_tpu/ops/pallas_kernels.py``.

:func:`slab_matmul` is the hand-written Hopper kernel of the slab engine
(``csrc/slab_matmul.cu``); :func:`slab_matmul_plain` is the same function in
plain PyTorch, used for CPU tensors and as the kernel's reference. The
chain-mode kernels (``apply_1q_chain``, ``apply_2q_adjacent`` and their
base case ``apply_1q``) are in :mod:`.gate_kernels`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..config import full_fp32_matmul

__all__ = ["slab_matmul", "slab_matmul_plain"]

_SLAB_DIMS = tuple(1 << s for s in range(1, 8))  # d = 2^S, S = 1..7


def _check(re, im, wt_re, wt_im) -> int:
    d = wt_re.shape[0] if wt_re.dim() == 2 else -1
    if d not in _SLAB_DIMS or tuple(wt_re.shape) != (d, d) \
            or tuple(wt_im.shape) != (d, d):
        raise ValueError(f"window must be (d, d) with d in {_SLAB_DIMS}, got "
                         f"{tuple(wt_re.shape)} and {tuple(wt_im.shape)}")
    for name, t in (("re", re), ("im", im), ("wt_re", wt_re),
                    ("wt_im", wt_im)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != re.device:
            raise ValueError(f"{name} is on {t.device}, re on {re.device}")
    if re.shape != im.shape or re.numel() % d or re.numel() == 0:
        raise ValueError(f"planes {tuple(re.shape)} and {tuple(im.shape)} "
                         f"must match and hold whole rows of {d}")
    return d


@functools.cache
def _kernel():
    fn = _build.load("slab_matmul").qct_slab_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slab_matmul_plain(re: torch.Tensor, im: torch.Tensor,
                      wt_re: torch.Tensor, wt_im: torch.Tensor):
    """``out = x @ Wt`` split-real over (R, d) rows, out of place.

    ``wt_re``/``wt_im`` are the ALREADY-TRANSPOSED window (as the kernel
    takes it). Returns flat ``(out_re, out_im)``.
    """
    d = _check(re, im, wt_re, wt_im)
    xr = re.reshape(-1, d)
    xi = im.reshape(-1, d)
    with full_fp32_matmul():
        out_r = torch.matmul(xr, wt_re) - torch.matmul(xi, wt_im)
        out_i = torch.matmul(xi, wt_re) + torch.matmul(xr, wt_im)
    return out_r.reshape(-1), out_i.reshape(-1)


def slab_matmul(re: torch.Tensor, im: torch.Tensor,
                wt_re: torch.Tensor, wt_im: torch.Tensor):
    """Apply a slab window in place: ``(re, im) <- x @ Wt``, split-real.

    On CUDA tensors this launches the Hopper kernel (3xTF32 on the tensor
    cores for d >= 64, FP32 FFMA for d <= 32) and returns the same
    ``(re, im)`` tensors, updated in place; on CPU tensors it returns
    :func:`slab_matmul_plain`'s new tensors. Any other device raises.
    """
    d = _check(re, im, wt_re, wt_im)
    if re.device.type == "cpu":
        return slab_matmul_plain(re, im, wt_re, wt_im)
    if re.device.type != "cuda":
        raise ValueError(f"slab_matmul runs on cuda or cpu, not {re.device}")
    if any(t.data_ptr() % 16 for t in (re, im, wt_re, wt_im)):
        raise ValueError("slab_matmul needs 16-byte aligned tensors")
    fn = _kernel()
    path = ctypes.c_int(-1)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = fn(re.data_ptr(), im.data_ptr(), wt_re.data_ptr(),
                 wt_im.data_ptr(), re.numel() // d, d, ctypes.byref(path),
                 stream)
    if err != 0:
        raise RuntimeError(f"slab_matmul kernel launch failed: CUDA error "
                           f"{err} (d={d}, rows={re.numel() // d})")
    slab_matmul.launches += 1
    slab_matmul.tensor_core_launches += path.value == 1
    return re, im


slab_matmul.launches = 0  # kernel launches, counted where they happen
# of those, launches of the 3xTF32 tensor-core kernel (d >= 64), as the C
# dispatcher reports them; d <= 32 runs the FFMA kernel
slab_matmul.tensor_core_launches = 0
