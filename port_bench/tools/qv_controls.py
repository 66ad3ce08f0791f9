"""The readings that the ``qv30_d30`` check's limits are set between, on
the card: for each seed, the first job a run of that seed makes (the fixed
stream's first circuit, the seed's amplitude indices and sampler seed) is
run as the timed path runs it, and the check's two readings are taken of

- the sound run;
- a planted fault in the sample remap: the samples' bits reversed;
- a planted fault in the circuit: one SU(4) (gate ``--gate``) applied
  with its targets swapped;
- the precision controls, one precision below the configuration's FP32
  window products: the timed path with every window a 1xTF32 product
  (:func:`tf32_windows`: both planes and the window rounded to TF32, to
  nearest or by clearing the low bits, then an FP32 product; on a card
  also the library's own TF32 product), and the reference with the inputs
  of every gate product's state and matrix cleared to TF32
  (``simulate(..., tf32_inputs=True)``), each read as if it were the
  port's amplitudes.

    python3 port_bench/tools/qv_controls.py --seeds 11,12,13 [--workload qv30_d30]

from the root of a checkout; prints one JSON line per seed, with the
seconds each part took.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tf32(x, rounding: str):
    """float32 ``x`` with its low 13 mantissa bits rounded off: to nearest,
    ties away from zero (``"nearest"``, as the card's ``cvt.rna.tf32.f32``),
    or cleared (``"truncate"``)."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + (1 << 12)
    return (bits & -(1 << 13)).view(x.dtype)


@contextlib.contextmanager
def tf32_windows(rounding: str):
    """The port's slab windows as 1xTF32 products while the block runs: the
    planes and the window rounded by :func:`tf32` and multiplied in FP32
    (``"nearest"``, ``"truncate"``), or the plain product with the
    library's TF32 allowed (``"library"``, a card's cuBLAS)."""
    from quantum_computations_tpu_torch.ops import slab_kernels

    saved = slab_kernels.slab_matmul, slab_kernels.full_fp32_matmul

    @contextlib.contextmanager
    def tf32_matmul():
        old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(old)

    if rounding == "library":
        slab_kernels.full_fp32_matmul = tf32_matmul
        slab_kernels.slab_matmul = slab_kernels.slab_matmul_plain
    else:
        plain = slab_kernels.slab_matmul_plain
        slab_kernels.slab_matmul = lambda *planes: plain(*(tf32(t, rounding) for t in planes))
    try:
        yield
    finally:
        slab_kernels.slab_matmul, slab_kernels.full_fp32_matmul = saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--workload", default="qv30_d30")
    parser.add_argument("--gate", type=int, default=200)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--qubits", type=int, default=None)
    args = parser.parse_args(argv)

    from port_bench.harness.bench import Cell, seeds
    from port_bench.reference.statevector import simulate

    cell = Cell(args.workload)
    config = dict(cell.config, **({"qubits": args.qubits} if args.qubits else {}))
    engine_module = cell.engine
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    free = torch.cuda.empty_cache if cuda else (lambda: None)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = {"seed": seed}
        job = cell.driver.make_client(config, cell.traffic, seeds(seed)[0])[0]()
        (sv,) = engine_module.make_engines(config, cell.traffic, args.device, 1)
        t = time.perf_counter()
        amps, (samples, norm), failed = engine_module.run_job(sv, job)
        sync()
        out.update(port_s=time.perf_counter() - t, norm_sq=norm, failed=failed)
        swapped = list(job.gates)
        u, (a, b) = swapped[args.gate]
        swapped[args.gate] = (u, (b, a))
        bad = engine_module.run_job(sv, type(job)(**dict(vars(job), gates=swapped)))[0]
        windows = {}
        for rounding in ("nearest", "truncate") + (("library",) if cuda else ()):
            t = time.perf_counter()
            with tf32_windows(rounding):
                windows[rounding], (_, norm), _ = engine_module.run_job(sv, job)
            sync()
            out[f"window_{rounding}_s"] = time.perf_counter() - t
            out[f"window_{rounding}_norm_sq"] = norm
        del sv
        n = job.N
        reversed_bits = np.zeros_like(samples)
        for bit in range(n):
            reversed_bits |= ((samples >> bit) & 1) << (n - 1 - bit)
        free()
        t = time.perf_counter()
        psi = simulate(job.gates, n, args.device)
        sync()
        out["reference_s"] = time.perf_counter() - t
        out["sound"] = engine_module.readings(job, amps, samples, psi)
        out["swapped_targets_amp_rel_err"] = engine_module.readings(job, bad, samples, psi)[0]
        out["reversed_samples_xeb_dev"] = engine_module.readings(job, amps, reversed_bits, psi)[1]
        for rounding, a in windows.items():
            out[f"window_{rounding}_amp_rel_err"] = engine_module.readings(job, a, samples, psi)[0]
        at = torch.from_numpy(job.indices).to(psi.device)
        a_ref = psi[at].cpu().numpy()
        del psi
        free()
        t = time.perf_counter()
        control = simulate(job.gates, n, args.device, tf32_inputs=True)
        sync()
        out["control_s"] = time.perf_counter() - t
        a_ctrl = control[at].cpu().numpy()
        out["control_norm_sq"] = float(torch.linalg.vector_norm(torch.view_as_real(control))) ** 2
        del control
        free()
        out["control_amp_rel_err"] = float(np.linalg.norm(a_ctrl - a_ref) / np.linalg.norm(a_ref))
        if cuda:
            out["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
