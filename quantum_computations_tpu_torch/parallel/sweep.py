"""Monte-Carlo sweep batching (counterpart of
``quantum_computations_tpu/parallel/sweep.py``).

Replaces the reference's ``multiprocessing.Pool(3).imap_unordered``
parameter sweeps (``average_clifford_fidelity.py:212-216`` et al.): one
trajectory function run over independent generators, optionally split
over the ranks of a 1-D mesh.

Differences from the JAX package, all deliberate: JAX's split PRNG keys
become ``torch.Generator``s seeded from
``np.random.SeedSequence(rng_seed).spawn(n)`` (trajectory i gets the same
generator whatever the rank count), the trajectories run one after another
(no vmap), and there is no ``jit=`` flag.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import as_generator
from .mesh import Mesh, data_mesh

__all__ = ["batched_sweep", "sharded_sweep"]


def _generators(rng_seed, lo: int, hi: int) -> list[torch.Generator]:
    """Host generators of trajectories lo..hi-1 of a sweep seeded by
    ``rng_seed``."""
    children = np.random.SeedSequence(rng_seed).spawn(hi)[lo:]
    return [as_generator(int(c.generate_state(1, np.uint64)[0] >> 1))
            for c in children]


def _stack(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(col) for col in zip(*outs))
    return torch.stack(outs)


def batched_sweep(trajectory_fn, n: int, rng_seed=None):
    """Run ``trajectory_fn(generator)`` (a tensor or a tuple of tensors)
    for n independent generators. Returns the results stacked along a
    leading batch axis of size n."""
    return _stack([trajectory_fn(g) for g in _generators(rng_seed, 0, n)])


def sharded_sweep(trajectory_fn, n: int, rng_seed=None, *,
                  mesh: Mesh | None = None):
    """:func:`batched_sweep` with the batch split over a 1-D mesh.

    n is rounded up to a multiple of the rank count D; each rank runs a
    contiguous slice, the slices are gathered on every rank (on
    ``mesh.device``) and the padding is dropped. Called by every rank of
    ``mesh`` (default: the whole world)."""
    mesh = mesh if mesh is not None else data_mesh()
    d = mesh.size
    per = (n + d - 1) // d
    if rng_seed is None:  # one entropy for the whole mesh
        seed = torch.tensor([np.random.SeedSequence().entropy % (1 << 62)],
                            device=mesh.device)
        rng_seed = int(mesh.broadcast(seed, 0).item())
    gens = _generators(rng_seed, mesh.rank * per, (mesh.rank + 1) * per)
    out = _stack([trajectory_fn(g) for g in gens])
    if isinstance(out, tuple):
        return tuple(mesh.all_gather(o.to(mesh.device))[:n] for o in out)
    return mesh.all_gather(out.to(mesh.device))[:n]
