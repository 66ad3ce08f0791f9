"""Cost of the port's span recorder with recording on, in a benchmark cell's
closed loop.

    python3 tools/recording_cost.py --workload rb_d8_10db --seed 4200000901 \
        --seconds 30 --order off,on,on,off

Makes the cell's clients once (``port_bench``'s harness: engines, one warm
batch per client), then drives the cell's untraced window once per entry
of ``--order`` in the same process, each on the same batches (the traffic
is drawn anew from ``--seed`` for every window), with
``utils.profiling.recording()`` held over the whole window where the entry
is ``on``. Prints one JSON line per window (trajectories per second as
``rb_traj_per_s`` reads them, batches, and for ``on`` the spans per
trajectory) and a last line with the mean rate of each mode. No reference
check is made. Needs a CUDA device.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _NoTape:
    def start(self):
        return None

    def stop(self):
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--order", default="off,on,on,off")
    args = parser.parse_args(argv)

    import torch

    from port_bench.harness.bench import Cell, seeds
    from port_bench.harness.loop import make_engines, run_clients
    from quantum_computations_tpu_torch.utils import profiling

    cell = Cell(args.workload)
    config, traffic = cell.config, cell.traffic
    engines = make_engines(config, float(traffic["db"]), "cuda", int(traffic.get("clients", 1)))
    warm_job, score = cell.driver.make_client(config, traffic, seeds(args.seed)[1])
    run_clients(engines, warm_job, score, _NoTape(), batches_per_client=1, serial=True)
    rates: dict[str, list[float]] = {}
    for mode in args.order.split(","):
        next_job, score = cell.driver.make_client(config, traffic, seeds(args.seed)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.recording() if mode == "on" else contextlib.nullcontext():
            batches = run_clients(engines, next_job, score, _NoTape(),
                                  deadline=t0 + args.seconds)
            torch.cuda.synchronize()
        t1 = max(b.end for b in batches)
        trajectories = sum(b.job.batch - b.failed for b in batches)
        rate = trajectories / (t1 - t0)
        rates.setdefault(mode, []).append(rate)
        row = {"workload": args.workload, "mode": mode, "traj_per_s": rate,
               "batches": len(batches), "window_s": t1 - t0}
        if mode == "on":
            row["spans_per_traj"] = len(profiling.last_recording().spans) / trajectories
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload,
                      "mean_traj_per_s": {m: sum(v) / len(v) for m, v in rates.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
