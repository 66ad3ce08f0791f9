"""Profiler integration and the port's span recorder (counterpart of
``quantum_computations_tpu/utils/profiling.py``).

- :func:`maybe_trace` — context manager that runs ``torch.profiler`` (host,
  and the card when there is one) when a directory is given explicitly or
  through ``QCT_PROFILE_DIR``, and writes a Chrome/Perfetto trace
  (``trace_<pid>_<n>.json``) into that directory on exit. The trace
  attributes device time per kernel.
- :func:`annotate` — a named ``record_function`` scope, so host-side phases
  (one per gate) show up as spans in the trace. Cheap when no profiler runs.
- :func:`span` — the engines' spans. When nothing records, it returns one
  shared null context after a flag check. While a ``torch.profiler``
  session runs anywhere in the process, or inside :func:`recording`, it
  stamps ``time.time_ns()`` at entry and exit into a buffer of the calling
  thread (with the thread's name and the enclosing span), and under a
  profiler it also enters ``record_function(label)``. The profiler keeps
  only the spans of the threads it was started in; the recorder keeps every
  thread's.
- :func:`last_recording` — the spans of the last recording, from its start
  to its end; :func:`table` sums them per label; :func:`to_trace_us` maps a
  stamp onto the exported Chrome trace's microseconds.

Usage::

    with maybe_trace("trace_dir"):
        sim.run(state)

    with recording():
        runner.run_circuit(circuit, coeffs, batch)
    table()  # {label: {"calls", "seconds", "self_seconds"}}

On an asynchronous device a span's host time is its dispatch, plus the
device time of whatever the span waits for.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

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


# -- the recorder ---------------------------------------------------------

class Span(NamedTuple):
    """One recorded span: ``parent`` is the index of the enclosing span of
    the same thread in :attr:`Recording.spans`, or None."""

    label: str
    thread: str
    start_ns: int
    end_ns: int
    parent: int | None


class Recording:
    """The spans of one recording, every thread's, from ``start_ns`` to
    ``end_ns`` (``time.time_ns()`` stamps)."""

    def __init__(self, start_ns: int, end_ns: int, spans: list[Span]):
        self.start_ns, self.end_ns, self.spans = start_ns, end_ns, spans

    def inside(self, label: str, ancestor: str) -> list[Span]:
        """The spans named ``label`` that lie inside a span named
        ``ancestor`` of their thread."""
        out = []
        for s in self.spans:
            if s.label != label:
                continue
            p = s.parent
            while p is not None and self.spans[p].label != ancestor:
                p = self.spans[p].parent
            if p is not None:
                out.append(s)
        return out

    def table(self) -> dict[str, dict]:
        """{label: {calls, seconds, self_seconds}} summed over threads,
        sorted by seconds; a span's self time leaves out its children's."""
        child_ns = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None:
                child_ns[s.parent] += s.end_ns - s.start_ns
        rows: dict[str, list] = {}
        for s, c in zip(self.spans, child_ns):
            row = rows.setdefault(s.label, [0, 0, 0])
            row[0] += 1
            row[1] += s.end_ns - s.start_ns
            row[2] += s.end_ns - s.start_ns - c
        return {k: {"calls": v[0], "seconds": v[1] / 1e9, "self_seconds": v[2] / 1e9}
                for k, v in sorted(rows.items(), key=lambda kv: -kv[1][1])}


class _Rec:
    __slots__ = ("label", "start", "end", "parent")

    def __init__(self, label, parent):
        self.label, self.parent, self.end = label, parent, None


class _Buffer:
    """One thread's spans of the recording ``epoch``, and its open spans."""

    __slots__ = ("thread", "epoch", "recs", "stack")

    def __init__(self):
        self.thread = threading.current_thread()
        self.epoch, self.recs, self.stack = 0, [], []


_lock = threading.Lock()       # registration and the recording's bounds
_local = threading.local()
_buffers: list[_Buffer] = []
_explicit = 0                  # depth of recording() blocks
_open = False                  # a recording is open
_auto = False                  # ... opened by a profiler session
_epoch = 0
_bounds: list | None = None    # [epoch, start_ns, end_ns] of the last recording


def _begin(auto: bool) -> None:
    global _open, _auto, _epoch, _bounds
    _epoch += 1
    _open, _auto = True, auto
    _bounds = [_epoch, time.time_ns(), None]
    # buffers of threads that have ended hold only older recordings
    _buffers[:] = [b for b in _buffers if b.thread.is_alive()]


def _end() -> None:
    global _open, _auto
    _open = _auto = False
    _bounds[2] = time.time_ns()


def _epoch_now() -> int | None:
    """The open recording, after opening one for a profiler session that
    has started or closing one whose session has ended."""
    profiled = _autograd_profiler._is_profiler_enabled
    if _open and (profiled or not _auto):
        return _epoch
    with _lock:
        if _open and _auto and not profiled:
            _end()
        if profiled and not _open:
            _begin(auto=True)
        return _epoch if _open else None


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _lock:
            _buffers.append(buf)
    return buf


class _Span:
    __slots__ = ("label", "rec", "buf", "rf")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        epoch = _epoch_now()
        if epoch is None:
            self.rec = None
            return self
        buf = self.buf = _buffer()
        if buf.epoch != epoch:
            buf.epoch, buf.recs = epoch, []
        rec = self.rec = _Rec(self.label, buf.stack[-1] if buf.stack else None)
        buf.recs.append(rec)
        buf.stack.append(rec)
        rec.start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.label)
            self.rf.__enter__()
        else:
            self.rf = None
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.end = time.time_ns()
        self.buf.stack.pop()
        return False


_NULL = contextlib.nullcontext()


def span(label: str):
    """A span of the recorder (see the module docstring); the shared null
    context when nothing records."""
    if _autograd_profiler._is_profiler_enabled or _open:
        return _Span(label)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record every thread's spans while the block runs (a new recording;
    nested blocks add to the outermost one)."""
    global _explicit
    with _lock:
        if _explicit == 0:
            if _open:
                _end()
            _begin(auto=False)
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1
            if _explicit == 0:
                _end()


def last_recording() -> Recording | None:
    """The finished spans of the last recording (None before the first):
    the last :func:`recording` block, or the last profiler session in
    which a span ran."""
    with _lock:
        if _open and _auto and not _autograd_profiler._is_profiler_enabled:
            _end()
        if _bounds is None:
            return None
        epoch, start, end = _bounds
        buffers = [(b.thread.name, list(b.recs)) for b in _buffers if b.epoch == epoch]
    spans: list[Span] = []
    for name, recs in buffers:
        index = {}
        for rec in recs:   # a parent is appended before its children
            if rec.end is None:
                continue
            index[id(rec)] = len(spans)
            parent = None if rec.parent is None else index.get(id(rec.parent))
            spans.append(Span(rec.label, name, rec.start, rec.end, parent))
    return Recording(start, time.time_ns() if end is None else end, spans)


def table() -> dict[str, dict]:
    """:meth:`Recording.table` of the last recording ({} before the first)."""
    rec = last_recording()
    return rec.table() if rec is not None else {}


_trace_base_ns: int | None = None


def to_trace_us(ns: int) -> float:
    """A ``time.time_ns()`` stamp in the microseconds of the Chrome trace
    that ``torch.profiler`` exports (``ts``): (ns − the export's
    ``baseTimeNanoseconds``) / 1000. The base is learned once per process,
    from a CPU-only profiler session of one operation, on the first call:
    make that call outside any measured window."""
    global _trace_base_ns
    if _trace_base_ns is None:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.zeros(1)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                _trace_base_ns = int(json.load(fh)["baseTimeNanoseconds"])
        finally:
            os.unlink(path)
    return (ns - _trace_base_ns) / 1e3
