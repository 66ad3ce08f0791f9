"""Rank meshes, sharded state vectors and Monte-Carlo sweeps on
``torch.distributed`` (counterpart of ``quantum_computations_tpu/parallel``).

The reference has no distributed backend; its only parallelism is
``multiprocessing.Pool`` sweeps (SURVEY.md §2.7). Here:

- :mod:`.mesh`: rank meshes (one binary mesh axis per sharded qubit for the
  DV engine; 1-D data meshes for trajectory sweeps) and :func:`launch`,
  which starts a world of processes;
- :mod:`.statevector`: a state vector sharded over a qubit mesh, with
  explicit pairwise exchanges for gates on sharded qubit axes;
- :mod:`.shardmap_sv`: the index-swap engine with lazy layouts and the
  fused-slab plan;
- :mod:`.sweep`: Monte-Carlo batching over seeded generators.
"""

from .mesh import data_mesh, launch, qubit_mesh
from .statevector import ShardedStateVector, apply_gate_sharded
from .sweep import batched_sweep, sharded_sweep

__all__ = [
    "qubit_mesh", "data_mesh", "ShardedStateVector", "apply_gate_sharded",
    "batched_sweep", "sharded_sweep", "launch",
]
