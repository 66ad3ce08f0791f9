"""Both packages' ``grover_compiled`` cell in complex128, the port replaying
the JAX program's draws: does the port's whole-circuit engine give the
JAX package's per-trajectory Grover success?

    python3 tools/grover_compiled_replay.py [trajectories] [grid_points]

The cell is ``pipelines/grover_compiled``'s defaults at one dB: Grover
[2, 7], 10 dB, grid 512 on [-20, 20], bond cap 8, rel_err 1e-2, seed 0
(default 4 trajectories), with the exact SVD (``svd_method="full"``) in
both packages: JAX on the CPU at x64 as ``jit(vmap(trajectory_with_readout))``
over the pipeline's keys (``split(PRNGKey(0), n)``), the port on the CPU
in complex128 with the JAX run's homodyne outcomes forced, through the
recorder and replay of ``tests/test_torch_compiled_gkp.py``. Prints one
JSON line: per-trajectory success and raw trace of each package, their
largest differences, the largest entry difference of the logical
densities, and the seconds each package took. Needs the JAX package, not
a GPU; at grid 512 each package runs a few hundred exact SVDs of up to
4096 x 4096 (tens of minutes on 8 CPU cores).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import quantum_computations_tpu.gkp.compiled as jcompiled  # noqa: E402
from quantum_computations_tpu.config import SVDOptions as JOpts  # noqa: E402
from quantum_computations_tpu.gkp import MBGKPCircuit as JCircuit, db2eps  # noqa: E402
from quantum_computations_tpu.pipelines import grover as jgrover  # noqa: E402

import quantum_computations_tpu_torch.gkp.compiled as tcompiled  # noqa: E402
from quantum_computations_tpu_torch.gkp import MBGKPCircuit as TCircuit  # noqa: E402
from quantum_computations_tpu_torch.pipelines import grover as tgrover  # noqa: E402

import test_torch_compiled_gkp as recorder  # noqa: E402

TAGGED = [2, 7]
DB = 10.0
OPTS = dict(max_bond_dim=8, rel_err=1e-2, svd_method="full")


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    qs = np.linspace(-20, 20, d)
    eps = float(db2eps(DB))
    # the recorder's replay maps outcomes to grid indices on its QS and
    # forces one draw per trajectory of its BATCH
    recorder.QS, recorder.BATCH = qs, n
    jgates, jinit = jgrover.grover(TAGGED)
    tgates, tinit = tgrover.grover(TAGGED)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    with pytest.MonkeyPatch.context() as mp:
        tagged, records = recorder._record_jax(mp)
        jc = JCircuit.transpile(jgates)
        jc.fill()
        jprog = jcompiled.CompiledGKP(jc, qs, eps, JOpts(**OPTS))
        coeffs = jnp.asarray(jcompiled.logical_coeffs(jinit))
        fn = tagged(lambda k: jprog.trajectory_with_readout(coeffs, k))
        t = time.perf_counter()
        _, jre, jim = jax.jit(jax.vmap(fn))(jnp.arange(n), keys)
        jrho = np.asarray(jre) + 1j * np.asarray(jim)
        jax_s = time.perf_counter() - t
        rec = records()
        _, left = recorder._replay_in_port(mp, rec)
        tc = TCircuit.transpile(tgates)
        tc.fill()
        tprog = tcompiled.CompiledGKP(tc, qs, eps, OPTS, device="cpu")
        t = time.perf_counter()
        _, tre, tim = tprog.batched_readout(tcompiled.logical_coeffs(tinit), n, rng_seed=0)
        trho = (tre + 1j * tim).numpy()
        port_s = time.perf_counter() - t
        unreplayed = left()
    js = [jgrover.success_probability(r, TAGGED) for r in jrho]
    ts = [tgrover.success_probability(r, TAGGED) for r in trho]
    print(json.dumps({
        "cell": {"tagged": TAGGED, "db": DB, "grid_points": d, **OPTS,
                 "trajectories": n, "dtype": "complex128"},
        "draws_not_replayed": unreplayed,
        "jax_success": js, "port_success": ts,
        "max_success_diff": float(np.max(np.abs(np.subtract(js, ts)))),
        "jax_trace": [float(np.trace(r).real) for r in jrho],
        "port_trace": [float(np.trace(r).real) for r in trho],
        "max_rho_diff": float(np.abs(jrho - trho).max()),
        "mean_success": {"jax": float(np.mean(js)), "port": float(np.mean(ts))},
        "sem_success": float(np.std(js) / np.sqrt(n)),
        "seconds": {"jax": jax_s, "port": port_s}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
