"""Seeded random generators (counterpart of
``quantum_computations_tpu/utils/rng.py``).

The JAX package threads PRNG keys and splits one per gate; the port hands
its stochastic steps one explicit ``torch.Generator``, drawn from in order.
A data-sharded batch draws through :class:`BatchShard`, :func:`draw_batch`
and :func:`draw_rows`, so each rank draws what the serial run draws for
its trajectories.
"""

from __future__ import annotations

import numpy as np
import torch


def as_generator(seed_or_generator=None,
                 device: str | torch.device = "cpu") -> torch.Generator:
    """Coerce a seed-or-generator argument into a ``torch.Generator``.

    None -> fresh entropy; int -> a generator on ``device`` seeded with it;
    a generator -> itself. The default device is the host, so that one seed
    draws the same numbers whatever device the state lives on.
    """
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if seed_or_generator is None:
        seed_or_generator = np.random.SeedSequence().entropy % (2**31)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_or_generator))
    return gen


class BatchShard(torch.Generator):
    """A host generator for rows ``lo..hi-1`` of a batch of ``total``
    trajectories, as one rank of a data-sharded run sees it.

    The serial run draws batch-shaped numbers from one generator: a vector
    of one number per trajectory (:func:`draw_batch`) or one draw per
    trajectory, in trajectory order (:func:`draw_rows`). Through those two
    helpers this generator makes every draw of the serial run of the same
    seed, in its order and shapes, and keeps the rows ``lo..hi-1``, so a
    rank draws for its trajectories exactly what the serial run draws for
    them.
    """

    def __new__(cls, seed: int, total: int, lo: int, hi: int):
        return super().__new__(cls, device="cpu")

    def __init__(self, seed: int, total: int, lo: int, hi: int):
        if not 0 <= lo < hi <= total:
            raise ValueError(f"rows {lo}..{hi - 1} of a batch of {total}")
        self.manual_seed(int(seed))
        self.total, self.lo, self.hi = int(total), int(lo), int(hi)
        self._row = 0  # next local row of the current per-row sweep


def draw_batch(generator: torch.Generator, n: int, draw):
    """``draw(m)`` makes one draw of m rows (one per trajectory); returns
    the n rows of this process: all of them for a plain generator, the rows
    of a :class:`BatchShard` out of a draw for its whole batch."""
    if not isinstance(generator, BatchShard):
        return draw(n)
    if n != generator.hi - generator.lo:
        raise ValueError(f"a draw of {n} rows for rows {generator.lo}.."
                         f"{generator.hi - 1}")
    return draw(generator.total)[generator.lo:generator.hi]


def draw_rows(generator: torch.Generator, n: int, draw, skip=None) -> list:
    """``[draw(i) for i in range(n)]``: one draw (or one group of draws)
    per trajectory, for the next n trajectories of this process.

    A :class:`BatchShard` also makes the draws of the other trajectories of
    the batch, in the serial run's order, and drops them: ``skip()`` (by
    default ``draw(0)``) before the first of its rows and after the last.
    A sweep over its rows may come in several calls."""
    if not isinstance(generator, BatchShard):
        return [draw(i) for i in range(n)]
    skip = skip or (lambda: draw(0))
    out = []
    for i in range(n):
        if generator._row == 0:
            for _ in range(generator.lo):
                skip()
        out.append(draw(i))
        generator._row += 1
        if generator._row == generator.hi - generator.lo:
            for _ in range(generator.total - generator.hi):
                skip()
            generator._row = 0
    return out
