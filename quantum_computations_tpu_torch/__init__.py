"""PyTorch/CUDA port of :mod:`quantum_computations_tpu`, for one NVIDIA H100.

The JAX package is the reference this port is held against; the port
imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and none asked for they raise.

Ported: every module of the JAX package:
- the DV large-N state-vector engine (:class:`.dv.FastStatevector`) in its
  slab, window and chain modes, and all four of its hand-written Hopper
  kernels: :func:`.ops.slab_kernels.slab_matmul` (slab mode) and
  :func:`.ops.gate_kernels.apply_1q_chain`,
  :func:`.ops.gate_kernels.apply_2q_adjacent` and
  :func:`.ops.gate_kernels.apply_1q` (chain mode);
- the CV grid-MPS engine (:mod:`.cv`: states, MPS, gates and
  ``cv.Simulator(gates, rng_seed=...).run(mps)``) on :mod:`.ops.linalg`
  (truncated SVD), :mod:`.ops.theta` and :mod:`.ops.interp` (grid
  transforms), with :mod:`.utils` (seeded generators, profiler spans);
  two-mode splits above ``cv.gates._STREAM_THRESHOLD`` elements run
  streamed (:mod:`.ops.streamed`) without forming the split matrix;
- the eager measurement-based GKP engine (:mod:`.gkp`: transpiler,
  gadgets, Bell insertion, ``gkp.Simulator``, logical readout) with the
  DV toolbox :mod:`.dv.qop` and :class:`.dv.Simulator` it needs;
- the production GKP trajectory engine
  :class:`.gkp.batched.BatchedGKP` (op granularity, adaptive trims, the
  SVD-free fused gadgets of :mod:`.ops.fused_gadget`, host rank
  tracking) with the :mod:`.gkp.compiled` helpers and the RB pipelines
  :mod:`.pipelines.rb` and :mod:`.pipelines.rb_batched`;
- the whole-circuit engine :class:`.gkp.compiled.CompiledGKP` (static
  caps, device control flow) and the research pipelines of
  :mod:`.pipelines` (Grover eager, batched and compiled, RB eager and
  compiled, analysis, tomography, Clifford fidelity);
- the threaded runners of ``rb_batched`` and ``grover_batched`` (one
  engine per Python thread, each on a CUDA stream of its own), the
  second paper's pipelines (:mod:`.pipelines.cv_circuits`,
  :mod:`.pipelines.gkp_ec`, :mod:`.pipelines.gkp_ec_validation`), and
  the host-side :mod:`.distill` and :mod:`.utils.colour`;
- the mesh engines of :mod:`.parallel` on ``torch.distributed`` (rank
  meshes and the :func:`.parallel.launch` launcher, the sharded state
  vectors, Monte-Carlo sweeps) and the data-sharded
  ``BatchedGKP.run_circuit(data_sharding=)``.
"""

from . import config

__all__ = ["config"]
