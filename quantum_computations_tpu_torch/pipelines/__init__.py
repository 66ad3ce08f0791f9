"""Research pipelines of the port (counterpart of
``quantum_computations_tpu/pipelines``): thin drivers over the engines.

- :mod:`.common`          — dataclass configs with a CLI, ``.dat`` JSON output
- :mod:`.circuits`        — DV circuit builders (Grover, oracles, CCZ)
- :mod:`.grover`          — GKP Grover sweep on the eager engine (``gkp_grover.dat``)
- :mod:`.grover_batched`  — Grover at production parameters on
  :class:`..gkp.batched.BatchedGKP` (one or more engine threads, each on
  a CUDA stream of its own)
- :mod:`.grover_compiled` — Grover sweep on :class:`..gkp.compiled.CompiledGKP`
- :mod:`.rb`              — random RB circuits and the eager RB sweep (``gkp_rb.dat``)
- :mod:`.rb_batched`      — randomised benchmarking on :class:`..gkp.batched.BatchedGKP`
  (``gkp_rb_batched.dat`` rows of {db, depth, fidelity, purity, trace};
  one or more engine threads)
- :mod:`.rb_compiled`     — RB on :class:`..gkp.compiled.CompiledGKP`
- :mod:`.analysis`        — RB fits, Grover success curves, Clifford summaries
- :mod:`.tomography`      — process tomography (numpy path, torch device core)
- :mod:`.clifford_fidelity` — Clifford-encoding fidelity (``gkp_cliff.dat``)
- :mod:`.cv_circuits`     — the GKP error-correction experiments' CV gate lists
- :mod:`.gkp_ec`          — EC projectors and the dense-grid logical density
- :mod:`.gkp_ec_validation` — the second paper's numerical tests and figures
"""
