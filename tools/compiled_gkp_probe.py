"""Probe of the whole-circuit GKP engine's conditioning on one NVIDIA GPU.

    python3 tools/compiled_gkp_probe.py [out.json]

Runs ``gkp/compiled.CompiledGKP`` on the two programs of ``chip_smoke.py``
phase 10d (rb_compiled's first depth-8 circuit at 5.83 dB, grid 512; the
CZ-only Grover [2, 7] at 10 dB, grid 512) and prints JSON lines of:

- ``saturation``: per bond cap, how many of one complex128 trajectory's
  splits keep a rank equal to the cap below the matrix's full rank;
- ``readings``: one trajectory in complex64, and under the ``tables_f32``
  and ``gram_c64`` controls, against complex128 with the draws and
  sketches replayed (``chip_smoke.c64_vs_c128_replayed``), per SVD method
  and seed;
- ``success``: grover_compiled's mean success (8 trajectories) per cap and
  SVD method.

Writes the whole result to ``out.json`` (default
``chiprun_out/compiled_gkp_probe.json``). Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from quantum_computations_tpu_torch.config import SVDOptions  # noqa: E402
from quantum_computations_tpu_torch.dv import State  # noqa: E402
from quantum_computations_tpu_torch.gkp.compiled import CompiledGKP, logical_coeffs  # noqa: E402
from quantum_computations_tpu_torch.ops import linalg  # noqa: E402
from quantum_computations_tpu_torch.pipelines.grover import success_probability  # noqa: E402
from quantum_computations_tpu_torch.pipelines.rb import random_circ  # noqa: E402

QS = np.linspace(-20, 20, 512)


def programs() -> dict:
    _, rb_circ = random_circ(2, 8, np.random.default_rng(0))
    gr_circ, gr_coeffs = cs.grover_circuit([2, 7])
    return {"rb_compiled": (rb_circ, cs.db_to_eps(5.83), logical_coeffs([State.ZERO] * 2), 16),
            "grover_compiled": (gr_circ, cs.db_to_eps(10.0), gr_coeffs, 8)}


def program(name: str, cap: int, method: str = "auto") -> CompiledGKP:
    circ, eps, _, _ = programs()[name]
    return CompiledGKP(circ, QS, eps, SVDOptions(max_bond_dim=cap, rel_err=1e-2,
                                                 svd_method=method), device="cuda")


def saturation(name: str, caps) -> dict:
    """Splits of one complex128 trajectory whose kept rank reaches the cap
    below the matrix's full rank."""
    coeffs = programs()[name][2]
    real = linalg.matrix_svd_split
    out = {}
    for cap in caps:
        ranks = []

        def split(m, c, *, max_bond_dim, **kw):
            m1, m2, rank = real(m, c, max_bond_dim=max_bond_dim, **kw)
            ranks.append((int(rank.max()), max_bond_dim, min(m.shape[-2:])))
            return m1, m2, rank

        with cs.patched(linalg, "matrix_svd_split", split), cs.x64_dtype():
            cs.compiled_run(program(name, cap), coeffs, 1, 2)
        out[cap] = {"splits": len(ranks),
                    "saturated": sum(r >= m and m < f for r, m, f in ranks),
                    "max_rank": max(r for r, _, _ in ranks)}
    return out


def readings(name: str, method: str, seed: int) -> dict:
    _, _, coeffs, cap = programs()[name]
    prog = program(name, cap, method)
    return cs.c64_vs_c128_replayed(lambda: cs.compiled_run(prog, coeffs, 1, seed), QS, None,
                                   f"{name} {method} seed {seed}",
                                   controls=("tables_f32", "gram_c64"))


def success(cap: int, method: str) -> dict:
    coeffs = programs()["grover_compiled"][2]
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, re, im = program("grover_compiled", cap, method).batched_readout(coeffs, 8, rng_seed=0)
    rho = (re.double() + 1j * im.double()).cpu().numpy()
    s = [success_probability(r, [2, 7]) for r in rho]
    return {"mean": float(np.mean(s)), "se": float(np.std(s) / np.sqrt(len(s))),
            "seconds": time.perf_counter() - t}


def main() -> int:
    if not torch.cuda.is_available():
        print("compiled_gkp_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out",
                                                               "compiled_gkp_probe.json")
    out = {"card": torch.cuda.get_device_name(0)}
    out["saturation"] = {"rb_compiled": saturation("rb_compiled", (16, 24, 32)),
                         "grover_compiled": saturation("grover_compiled", (8, 16, 24, 32))}
    print(json.dumps({"saturation": out["saturation"]}), flush=True)
    out["readings"] = {f"{name} {method} {seed}": readings(name, method, seed)
                       for name in ("rb_compiled", "grover_compiled")
                       for method in ("auto", "full") for seed in (2, 3, 4)}
    print(json.dumps({"readings": out["readings"]}), flush=True)
    out["success"] = {f"{cap} {method}": success(cap, method)
                      for cap, method in ((8, "auto"), (8, "full"), (16, "auto"), (32, "auto"))}
    print(json.dumps({"success": out["success"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
