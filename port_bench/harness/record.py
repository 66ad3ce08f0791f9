"""The draws of the timed path, kept for the reference.

The port draws every random number of a trajectory batch from one host
``torch.Generator``: a grid index per homodyne (``ops.fused_gadget._draw``,
``gkp.compiled._draw``) and a Gaussian range-finder sketch per trajectory
and randomized split (``ops.linalg._gaussian_sketch``). :class:`DrawRecorder`
wraps those three functions for the whole run and files what each engine
thread draws on the tape of the batch it is running: the index tensors as
the port made them (no copy and no sync) and, for a sketch, the state of
the generator before the draw with the sketch's shape, from which the
reference draws the same numbers again. A streamed split's sketches are
not kept: the reference has no copy of that split and refuses the batch.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class BatchTape:
    """The draws of one batch, in the order the port made them."""

    def __init__(self):
        self.indices: list[torch.Tensor] = []
        self.sketches: list[tuple[torch.Tensor, int, int, bool]] = []

    def for_reference(self) -> tuple[list[np.ndarray], list]:
        """(indices as host arrays, sketch records) for ``reference.engine.Tape``."""
        return [i.cpu().numpy() for i in self.indices], list(self.sketches)


class DrawRecorder:
    """Wraps the port's draw functions while it is entered; each thread
    records on the tape it last :meth:`start`-ed (none: nothing kept)."""

    def __init__(self):
        self._local = threading.local()
        self._stack = contextlib.ExitStack()

    def start(self) -> BatchTape:
        tape = BatchTape()
        self._local.tape = tape
        return tape

    def stop(self) -> None:
        self._local.tape = None

    def _tape(self) -> BatchTape | None:
        return getattr(self._local, "tape", None)

    def __enter__(self):
        from quantum_computations_tpu_torch.gkp import compiled
        from quantum_computations_tpu_torch.ops import fused_gadget, linalg

        real_draw = fused_gadget._draw
        real_sketch = linalg._gaussian_sketch

        def draw(dist, forced, generator):
            idx = real_draw(dist, forced, generator)
            tape = self._tape()
            if tape is not None:
                tape.indices.append(idx)
            return idx

        def sketch(n, l, generator, like):
            tape = self._tape()
            if tape is not None and generator is not None:
                state = generator.get_state()
                tape.sketches.append((state, int(n), int(l),
                                      like.dtype in (torch.complex64, torch.float32)))
            return real_sketch(n, l, generator, like)

        for module, name, fn in ((fused_gadget, "_draw", draw), (compiled, "_draw", draw),
                                 (linalg, "_gaussian_sketch", sketch)):
            self._stack.callback(setattr, module, name, getattr(module, name))
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False
