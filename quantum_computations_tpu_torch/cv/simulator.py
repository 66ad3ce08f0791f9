"""CV circuit engine (counterpart of
``quantum_computations_tpu/cv/simulator.py``).

Sequential gate loop with the svd-options cascade, a named profiler span
and a timing log per gate, and measurement recording. Randomness: one
seeded host ``torch.Generator``, handed to every gate and drawn from in
gate order, so a seed gives the same outcomes on every run and device.
"""

from __future__ import annotations

import logging
from collections.abc import Callable
from timeit import default_timer as timer

import numpy as np
import torch

from ..config import SVDOptions
from ..utils import annotate, as_generator, maybe_trace
from .gate_abc import Gate, MeasurementResult
from .mps import MPS

logger = logging.getLogger(__name__)


def format_time(time_in_seconds: float) -> str:
    t = time_in_seconds
    mins = int(np.floor(t // 60))
    t = t % 60
    secs = int(np.floor(t))
    millies = round((t - secs) * 1000)
    return ":".join([str(mins).rjust(2, "0"), str(secs).rjust(2, "0"), str(millies).rjust(3, "0")])


class Simulator:
    """Run a list of CV gates over an MPS.

    ``rng_seed`` is an int, a ``torch.Generator`` or None (fresh entropy);
    ``svd_options`` is an :class:`SVDOptions` (or dict) applied to gates
    that don't override it. ``debug_info(simulator)`` runs after every gate
    when this module's logger is enabled for DEBUG.
    """

    def __init__(
        self,
        gates: list[Gate],
        rng_seed=None,
        *,
        debug_info: Callable | None = None,
        measurement_formatter: Callable | None = None,
        svd_options: SVDOptions | dict | None = None,
    ):
        self._gates = gates
        self._state: MPS | None = None
        self.generator: torch.Generator = as_generator(rng_seed)
        self.results: list[MeasurementResult] | None = None
        self.debug_info = debug_info or (lambda _: None)
        self.meas_format = measurement_formatter
        if isinstance(svd_options, dict):
            svd_options = SVDOptions(**svd_options)
        self._svd_options = svd_options or SVDOptions()

    def apply_gate(self, gate: Gate):
        start = timer()
        with annotate(f"cv:{type(gate).__name__}"):
            output = gate.apply(self._state, generator=self.generator,
                                svd_options=self._svd_options)
        end = timer()

        if isinstance(output, MeasurementResult):
            self.results.append(output)
            logger.info(
                "   measurement result : "
                + (self.meas_format(output) if self.meas_format else str(output))
            )
        logger.info(f"   mps shape: {self._state.shape()}")
        logger.info("   evaluation time : " + format_time(end - start))
        if logger.isEnabledFor(logging.DEBUG):
            self.debug_info(self)

    def run(self, initial_state: MPS, *, profile_dir: str | None = None) -> MPS:
        """Run the circuit. ``profile_dir`` (or env ``QCT_PROFILE_DIR``)
        captures a ``torch.profiler`` trace of the whole run with one named
        span per gate."""
        initial_state.validate()
        self._state = initial_state
        self.results = []
        circ_start = timer()
        logger.info(f"Total number of gates: {len(self._gates)}")
        with maybe_trace(profile_dir):
            for i, gate in enumerate(self._gates):
                logger.info(f"Gate {i}: {gate}")
                self.apply_gate(gate)
        logger.info("Finished!")
        logger.info("Total time: " + format_time(timer() - circ_start))
        return self._state
