"""Readings that set a cell's check limits (not run by the benchmark's runs).

    python3 port_bench/calibrate.py --workload <name> --seeds 11,12,13 --seconds 5 \
        [--control] [--draw-shift K]

For each seed, in one process (set-up once): a short window of the cell's
own traffic and clients, then for the batches the check would pick, the
sound reading (the timed path's outputs against the complex128 reference)
and, with ``--control``, the control's (the reference in complex64 with
TF32 products, the precision below the configuration's float32 without
TF32, against the complex128 reference). ``--draw-shift K`` plants a
fault in the program: every homodyne index moves by K grid points where
the port draws it, so the port's state follows the moved outcome and only
``draw_ks`` can see it. One JSON line per seed on standard output and in
``port_bench/out/calibrate_<workload>.jsonl``.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--draw-shift", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import gc

    import numpy as np
    import torch

    from port_bench.engines.gkp import check as checking
    from port_bench.harness.bench import OUT_DIR, Cell, log, pick, seeds
    from port_bench.harness.loop import run_clients

    cell = Cell(args.workload)
    config, traffic = cell.config, cell.traffic
    db = float(traffic["db"])
    engines = cell.engine.make_engines(config, traffic, args.device,
                                       int(traffic.get("clients", 1)))
    if args.draw_shift:
        from quantum_computations_tpu_torch.ops import fused_gadget
        real_draw = fused_gadget._draw

        def shifted(dist, forced, generator):
            return (real_draw(dist, forced, generator) + args.draw_shift).clamp(0, dist.shape[1] - 1)

        fused_gadget._draw = shifted
    OUT_DIR.mkdir(exist_ok=True)
    out_path = OUT_DIR / f"calibrate_{args.workload}.jsonl"
    with cell.engine.recorder() as recorder, open(out_path, "a") as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            rng_traffic, _, rng_check = seeds(seed)
            next_job, score = cell.driver.make_client(config, traffic, rng_traffic)
            t = time.perf_counter()
            batches = run_clients(engines, next_job, score, recorder, run_job=cell.engine.run_job,
                                  deadline=time.perf_counter() + args.seconds)
            window = time.perf_counter() - t
            row = {"workload": args.workload, "seed": seed, "draw_shift": args.draw_shift,
                   "batches": len(batches), "window_s": window,
                   "largest": {k: list(v) for k, v in engines[0].largest.items()},
                   "reference_s": 0.0, "control_s": 0.0, "gap_diff": []}
            chosen = pick(batches, int(traffic.get("check_batches", 1)), rng_check)
            sound, control = [], []
            for i in chosen:
                b = batches[i]
                gc.collect()
                t = time.perf_counter()
                ref_rho, ref_frames, cut_gap, pits = checking.reference_of(
                    b, config, db, args.device, rng=rng_check)
                row["reference_s"] += time.perf_counter() - t
                sound.append(checking.readings(b.out, b.aux, ref_rho, ref_frames, cut_gap, pits))
                row["gap_diff"] += [[float(f"{g:.3g}"), float(f"{x:.3g}")] for g, x in zip(
                    cut_gap, np.max(np.abs(b.out - ref_rho), axis=(1, 2)))]
                if args.control:
                    t = time.perf_counter()
                    c_rho, c_frames, _, _ = checking.reference_of(
                        b, config, db, args.device, dtype=torch.complex64, tf32=True)
                    row["control_s"] += time.perf_counter() - t
                    control.append(checking.readings(c_rho, c_frames, ref_rho, ref_frames,
                                                     cut_gap, pits))
            row["sound"] = checking.combine(sound) if sound else None
            row["control"] = checking.combine(control) if control else None
            del batches
            log(json.dumps(row))
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
