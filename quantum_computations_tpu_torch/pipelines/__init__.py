"""Research pipelines of the port (counterpart of
``quantum_computations_tpu/pipelines``): thin drivers over the engines.

- :mod:`.common`     — dataclass configs with a CLI, ``.dat`` JSON output
- :mod:`.rb`         — random RB circuits (``random_circ``)
- :mod:`.rb_batched` — randomised benchmarking on :class:`..gkp.batched.BatchedGKP`
  (``gkp_rb_batched.dat`` rows of {db, depth, fidelity, purity, trace})
"""
