"""The JAX package's grover_compiled pipeline at its defaults, on the CPU.

    python3 tools/grover_compiled_jax_cpu.py [trajectories]

Runs ``quantum_computations_tpu.pipelines.grover_compiled.main`` at its
default grid, bond cap and tags (grid 512, cap 8, [2, 7]) at 10 dB for
``trajectories`` trajectories (default 4), on the CPU in JAX's default
precision, and prints one JSON line: the seconds taken, the mean success
per epsilon and the raw traces. The reference reading for the port's
``grover_compiled`` at the same settings (``chip_smoke.py`` phase 10d).
Needs the JAX package, not a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from quantum_computations_tpu.pipelines import grover_compiled as gc  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        data = gc.main(gc.GroverCompiledConfig(dbs="10.0", traj_per_db=n,
                                               data_file=os.path.join(tmp, "g.dat")))
        seconds = time.perf_counter() - t
    print(json.dumps({"seconds": seconds, "trajectories": n,
                      "mean_success": {str(k): v for k, v in gc.summarize(data, [2, 7]).items()},
                      "traces": [float(np.trace(np.array(r["rho_real"]))) for r in data]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
