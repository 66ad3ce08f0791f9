"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the port (``quantum_computations_tpu_torch``). The run sets up the
cell's clients, warms one batch per client, drives them in closed loop
for ``--seconds``, checks batches of the window against the plain
reference, and prints one JSON object as the last line of standard output
(with ``--trace 1`` the per-layer metrics, from the first batches of the
window under the profiler). It exits non-zero and prints no result
without enough CUDA devices, or if JAX, its libraries or the JAX package
were loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "port_bench" / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from port_bench.harness.bench import Cell, forbidden_modules, log, run_cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    if cell.limits is None:
        log(f"no limits for {args.workload} (port_bench/limits/{args.workload}.json)")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), start=START)

    build = sys.modules.get("quantum_computations_tpu_torch.ops._build")
    log(f"kernel libraries loaded: {len(build._loaded) if build else 0}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in the process that reports: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
