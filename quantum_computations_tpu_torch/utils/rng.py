"""Seeded random generators (counterpart of
``quantum_computations_tpu/utils/rng.py``).

The JAX package threads PRNG keys and splits one per gate; the port hands
its stochastic steps one explicit ``torch.Generator``, drawn from in order.
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
