"""Profiler integration (counterpart of
``quantum_computations_tpu/utils/profiling.py``).

Two entry points:

- :func:`maybe_trace` — context manager that runs ``torch.profiler`` (host,
  and the card when there is one) when a directory is given explicitly or
  through ``QCT_PROFILE_DIR``, and writes a Chrome/Perfetto trace
  (``trace_<pid>_<n>.json``) into that directory on exit. The trace
  attributes device time per kernel.
- :func:`annotate` — a named ``record_function`` scope, so host-side phases
  (one per gate) show up as spans in the trace. Cheap when no profiler runs.

Usage::

    with maybe_trace("trace_dir"):
        sim.run(state)

:class:`WallClock` and :func:`span` are the host wall-clock attribution of
the JAX package; a span's seconds sum over the threads that enter it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

PROFILE_ENV = "QCT_PROFILE_DIR"
_trace_ids = itertools.count()


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """Run ``torch.profiler`` and write a trace if a directory is configured.

    ``trace_dir`` wins over the ``QCT_PROFILE_DIR`` environment variable;
    with neither set this is a no-op context. Yields the directory.
    """
    d = trace_dir or os.environ.get(PROFILE_ENV)
    if not d:
        yield None
        return
    os.makedirs(d, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield d
    prof.export_chrome_trace(
        os.path.join(d, f"trace_{os.getpid()}_{next(_trace_ids)}.json"))


def annotate(label: str):
    """Named trace span (host scope) for a gate/gadget/stage."""
    return torch.profiler.record_function(label)


class WallClock:
    """Host wall-clock attribution for host-driven engines.

    Enable with ``QCT_TIMING=1`` or ``WallClock.enable()``; read
    ``WallClock.table()``. On an asynchronous device a span measures
    dispatch, plus the device time of whatever the span waits for.
    """

    enabled = bool(os.environ.get("QCT_TIMING"))
    _acc: dict[str, list] = {}
    _lock = threading.Lock()  # engine threads add to the same spans

    @classmethod
    def enable(cls, on: bool = True):
        cls.enabled = on

    @classmethod
    def reset(cls):
        cls._acc.clear()

    @classmethod
    @contextlib.contextmanager
    def span(cls, label: str):
        if not cls.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with cls._lock:
                slot = cls._acc.setdefault(label, [0.0, 0])
                slot[0] += dt
                slot[1] += 1

    @classmethod
    def table(cls) -> dict[str, dict]:
        """{label: {seconds, calls, fraction}} sorted by time desc."""
        total = sum(v[0] for v in cls._acc.values()) or 1.0
        rows = sorted(cls._acc.items(), key=lambda kv: -kv[1][0])
        return {k: {"seconds": round(v[0], 3), "calls": v[1],
                    "fraction": round(v[0] / total, 4)} for k, v in rows}


def span(label: str):
    """Combined profiler annotation + wall-clock span."""
    ctx = contextlib.ExitStack()
    ctx.enter_context(annotate(label))
    ctx.enter_context(WallClock.span(label))
    return ctx
