"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, checks the slab
state-vector engine against a dense numpy reference, then drives the main
path at full width: ``FastStatevector(30, device="cuda")`` in slab mode
(two float32 planes of 4 GiB each, updated in place) through
``run_compiled``. Prints one line per phase with its wall time, then the
card's name and power limit, a JSON line of per-kernel numbers, and as its
last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
and prints no result; so does a machine without a CUDA device.

Imports nothing of JAX: the references are the port's plain versions and
numpy.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (FP32 outside the tensor cores; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_FULL = 30          # full width: 2 x 4 GiB float32 planes
N_CHECK = 14         # engine vs dense complex128 reference
REPS = 5             # timed chains per main-path run
KERNEL_RTOL = 1e-5   # max|kernel - plain| <= KERNEL_RTOL * max|plain|
_T0 = time.perf_counter()


def log(msg: str):
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name} ...")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name} ok in {time.perf_counter() - self.t:.2f}s")
        return False


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def random_window(d: int, seed: int):
    """A random unitary window, TRANSPOSED, as float32 (wt_re, wt_im)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    wt = q.T
    return (torch.from_numpy(np.ascontiguousarray(wt.real, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(wt.imag, np.float32)).cuda())


def random_planes(n: int, seed: int):
    """Unit-norm random planes made on the card (2^N values each)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = (2.0 * n) ** -0.5
    re = torch.randn(n, device="cuda", generator=g).mul_(scale)
    im = torch.randn(n, device="cuda", generator=g).mul_(scale)
    return re, im


def kernel_vs_plain(sk, re, im, wt_re, wt_im) -> tuple[float, float]:
    """(max abs error, relative error) of the in-place kernel against the
    plain version on the same inputs; raises on disagreement."""
    want_r, want_i = sk.slab_matmul_plain(re, im, wt_re, wt_im)
    got_r, got_i = re.clone(), im.clone()
    ptrs = (got_r.data_ptr(), got_i.data_ptr())
    out = sk.slab_matmul(got_r, got_i, wt_re, wt_im)
    torch.cuda.synchronize()
    if (out[0].data_ptr(), out[1].data_ptr()) != ptrs:
        raise AssertionError("slab_matmul did not update the planes in place")
    err = max((got_r - want_r).abs().max().item(),
              (got_i - want_i).abs().max().item())
    scale = max(want_r.abs().max().item(), want_i.abs().max().item())
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError(f"slab_matmul disagrees with its plain version: "
                             f"max abs err {err:.3e} > {KERNEL_RTOL} x {scale:.3e}")
    return err, err / scale


def dense_reference(gates, n: int) -> np.ndarray:
    """complex128 state vector of ``gates`` from |0...0>, big-endian."""
    psi = np.zeros((2,) * n, np.complex128)
    psi[(0,) * n] = 1.0
    for g in gates:
        mat, tgts = (g if isinstance(g, tuple) else (g.matrix, tuple(g.indices)))
        k = len(tgts)
        op = np.asarray(mat, np.complex128).reshape((2,) * (2 * k))
        psi = np.tensordot(op, psi, axes=(list(range(k, 2 * k)), list(tgts)))
        psi = np.moveaxis(psi, list(range(k)), list(tgts))
    return psi.reshape(-1)


def logical_amplitudes(sv) -> np.ndarray:
    re, im, axis_of = sv.to_numpy()
    amp = (re.astype(np.float64) + 1j * im).reshape((2,) * sv.N)
    return amp.transpose(axis_of).reshape(-1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from quantum_computations_tpu_torch.dv import FastStatevector, gates, qop
    from quantum_computations_tpu_torch.dv import fast_sv
    from quantum_computations_tpu_torch.ops import _build, slab_kernels as sk

    with Phase("0 card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    with Phase("1 build"):
        t = time.perf_counter()
        logs = _build.build(["slab_matmul"])
        for name, out in logs.items():
            log(f"built {name} in {time.perf_counter() - t:.2f}s, cache hit: "
                f"{out is None}")
            for line in (out or "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")

    with Phase("2 kernel vs plain"):
        for d in (16, 128):
            for rows in (1, 3, 1 << 14, 1 << 20):
                re, im = random_planes(rows * d, seed=rows + d)
                wt = random_window(d, seed=d)
                err, rel = kernel_vs_plain(sk, re, im, *wt)
                log(f"slab_matmul d={d} rows={rows}: max abs err {err:.3e}, "
                    f"rel {rel:.3e} (tol {KERNEL_RTOL} x max|plain|), "
                    f"launches so far {sk.slab_matmul.launches}")
        del re, im, wt  # phase 4 reads the peak memory of the engine alone

    with Phase("3 engine vs dense reference"):
        rng = np.random.default_rng(3)
        circuit = []
        for layer in range(6):
            for q in range(N_CHECK):
                axis = rng.normal(size=3)
                circuit.append((qop.axis_rotation(rng.uniform(0, 2 * np.pi),
                                                  axis / np.linalg.norm(axis)),
                                (q,)))
            for _ in range(4):
                a, b = (int(x) for x in rng.choice(N_CHECK, 2, replace=False))
                circuit.append(gates.CZ(a, b) if layer % 2 else gates.CX(a, b))
        want = dense_reference(circuit, N_CHECK)
        for label, attrs, runner in (
                ("run", {}, "run"), ("run_compiled", {}, "run_compiled"),
                ("minor-safe moves S=4", dict(slab_bits=4, scatter_move_max=0),
                 "run_compiled")):
            sv = FastStatevector(N_CHECK, device="cuda")
            for k, v in attrs.items():
                setattr(sv, k, v)
            getattr(sv, runner)(circuit)
            got = logical_amplitudes(sv)
            fid = abs(np.vdot(want, got)) ** 2
            log(f"N={N_CHECK} {label}: {len(circuit)} gates, layout passes "
                f"{sv.layout_passes}, fidelity {fid:.9f}")
            if not fid > 1 - 1e-5:
                raise AssertionError(f"fidelity {fid} <= 1 - 1e-5 ({label})")

    # -- the main path at full width --------------------------------------
    H = np.asarray(qop.H)
    spread = list(dict.fromkeys((3 + 2 * i) % (N_FULL - 1) for i in range(14)))
    h_chain = [(H, (q,)) for q in (spread * 2)[:24]]
    T = np.asarray(qop.T)
    resident_chain = ([(H, (q,)) for q in range(N_FULL - 7, N_FULL)]
                      + [(T, (q,)) for q in range(N_FULL - 7, N_FULL)])
    chains = (("a: 24 H on 14 qubits", h_chain),
              ("b: slab-resident 7 H + 7 T", resident_chain))
    main = {}
    torch.cuda.reset_peak_memory_stats()
    sk.slab_matmul.launches = 0
    with Phase(f"4 main path N={N_FULL}"):
        for label, chain in chains:
            sv = FastStatevector(N_FULL, device="cuda")  # identity layout
            for _ in range(3):
                sv.run_compiled(chain)
            torch.cuda.synchronize()
            passes0, launches0 = sv.layout_passes, sk.slab_matmul.launches
            t = time.perf_counter()
            for _ in range(REPS):
                sv.run_compiled(chain)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / REPS * 1e3
            norm_err = abs(sv.norm_sq() - 1.0)
            main[label] = dict(
                ms_per_chain=ms, ms_per_gate=ms / len(chain),
                layout_passes_per_chain=(sv.layout_passes - passes0) / REPS,
                launches_per_chain=(sk.slab_matmul.launches - launches0) / REPS)
            log(f"N={N_FULL} chain {label}: {ms:.3f} ms/chain, "
                f"{ms / len(chain):.4f} ms/gate, layout passes/chain "
                f"{main[label]['layout_passes_per_chain']}, kernel "
                f"launches/chain {main[label]['launches_per_chain']}, "
                f"|norm_sq - 1| {norm_err:.2e}")
            if not norm_err < 1e-3:
                raise AssertionError(f"|norm_sq - 1| = {norm_err} >= 1e-3")
            del sv
    main_launches = sk.slab_matmul.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: slab_matmul launches {main_launches}, "
        f"max_memory_allocated {peak_gib:.2f} GiB")
    print(json.dumps({"main_path": main, "n_qubits": N_FULL,
                      "max_memory_allocated_gib": peak_gib}), flush=True)
    if main_launches < 1:
        raise AssertionError("the main path launched no slab_matmul kernel")

    with Phase(f"5 kernel at the main path's shape (N={N_FULL}, d=128)"):
        d = 128
        n = 1 << N_FULL
        rows = n // d
        re, im = random_planes(n, seed=5)
        wt_re, wt_im = random_window(d, seed=7)
        err, rel = kernel_vs_plain(sk, re, im, wt_re, wt_im)
        log(f"slab_matmul at N={N_FULL}: max abs err {err:.3e}, rel {rel:.3e}")
        ms = cuda_ms(lambda: sk.slab_matmul(re, im, wt_re, wt_im), 5)
        plain_ms = cuda_ms(lambda: sk.slab_matmul_plain(re, im, wt_re, wt_im), 3)
        swap = fast_sv._block_swap_plan(N_FULL, 7)[0]
        swap_ms = cuda_ms(lambda: fast_sv._permute_copy(re, *swap), 3)
        log(f"layout pass (slab<->B block swap) per plane: {swap_ms:.3f} ms; "
            f"bytes bound {2 * n * 4 / PEAK_BYTES_PER_S * 1e3:.3f} ms")
        xc = torch.complex(re, im).reshape(rows, d)
        del re, im
        wtc = torch.complex(wt_re, wt_im)
        library_ms = cuda_ms(lambda: torch.matmul(xc, wtc), 3)
        del xc
        bytes_ms = (4 * n * 4 + 2 * d * d * 4) / PEAK_BYTES_PER_S * 1e3
        ops_ms = 8 * rows * d * d / PEAK_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"slab_matmul per window: {ms:.3f} ms; bound {bound_ms:.3f} ms "
            f"(bytes {bytes_ms:.3f}, FP32 operations {ops_ms:.3f}); plain "
            f"{plain_ms:.3f} ms; library (one complex64 torch.matmul) "
            f"{library_ms:.3f} ms")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "slab_matmul", "route": "cuda",
        "source": "quantum_computations_tpu_torch/ops/csrc/slab_matmul.cu",
        "replaces": "quantum_computations_tpu/ops/pallas_kernels.py:254",
        "launches": main_launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
