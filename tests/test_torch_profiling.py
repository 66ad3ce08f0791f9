"""The port's span recorder (``quantum_computations_tpu_torch.utils.profiling``)
on the CPU: the null path, every thread's spans under a profiler session,
the mapping onto the exported trace's clock, self time, recordings kept
apart, and the spans of a tiny ``BatchedGKP`` run."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.utils import profiling


def _profile(fn, tmp_path):
    """``fn()`` under a CPU profiler session; returns the exported trace's
    complete events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def test_span_with_nothing_recording_is_the_shared_null_context(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda label: entered.append(label) or real(label))
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    with profiling.span("a"):
        pass
    assert entered == []
    with profiling.recording():            # recording, but no profiler: no record_function
        with profiling.span("a"):
            pass
    assert entered == []
    assert profiling.table()["a"]["calls"] == 1


def test_profiler_session_records_every_threads_spans(tmp_path):
    def worker(i):
        with profiling.span(f"work:{i}"):
            time.sleep(0.002)

    def run():
        with profiling.span("main"):
            threads = [threading.Thread(target=worker, args=(i,), name=f"engine-{i}")
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

    events = _profile(run, tmp_path)
    spans = profiling.last_recording().spans
    by_label = {s.label: s for s in spans}
    assert sorted(by_label) == ["main", "work:0", "work:1", "work:2", "work:3"]
    for i in range(4):
        assert by_label[f"work:{i}"].thread == f"engine-{i}"
        assert by_label[f"work:{i}"].parent is None      # no span of its own thread holds it
    assert by_label["main"].thread == threading.current_thread().name
    names = {e["name"] for e in events}
    assert "main" in names
    assert not names & {f"work:{i}" for i in range(4)}   # the profiler drops them


def test_threads_registering_at_once_lose_no_span():
    """More threads than cores, each registering its buffer and recording
    nested spans while the interpreter switches threads as often as it can:
    every span is kept, in its thread, under its parent."""
    n_threads, n_spans = 24, 200
    start = threading.Barrier(n_threads)

    def worker():
        start.wait(timeout=30)
        for _ in range(n_spans):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=worker, name=f"stress-{i}")
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = profiling.last_recording()
    rows = rec.table()
    assert rows["outer"]["calls"] == rows["inner"]["calls"] == n_threads * n_spans
    for s in rec.spans:
        if s.label == "inner":
            parent = rec.spans[s.parent]
            assert parent.label == "outer" and parent.thread == s.thread
    assert {s.thread for s in rec.spans} == {f"stress-{i}" for i in range(n_threads)}


def test_recorded_span_holds_its_trace_event_on_the_trace_clock(tmp_path):
    def run():
        with profiling.span("probe:clock"):
            time.sleep(0.005)

    events = _profile(run, tmp_path)
    (ev,) = [e for e in events if e["name"] == "probe:clock"]
    (s,) = [s for s in profiling.last_recording().spans if s.label == "probe:clock"]
    start, end = profiling.to_trace_us(s.start_ns), profiling.to_trace_us(s.end_ns)
    assert 0 <= ev["ts"] - start < 1000
    assert 0 <= end - (ev["ts"] + ev["dur"]) < 1000


def test_table_self_time_leaves_out_the_children():
    with profiling.recording():
        with profiling.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.003)
    rows = profiling.table()
    assert rows["outer"]["calls"] == 1 and rows["inner"]["calls"] == 2
    assert rows["inner"]["self_seconds"] == rows["inner"]["seconds"]
    assert rows["outer"]["self_seconds"] == pytest.approx(
        rows["outer"]["seconds"] - rows["inner"]["seconds"], abs=1e-9)
    assert 0.002 <= rows["outer"]["self_seconds"] < rows["outer"]["seconds"] - 0.006
    rec = profiling.last_recording()
    assert [s.label for s in rec.inside("inner", "outer")] == ["inner", "inner"]
    assert rec.inside("outer", "inner") == []


def test_each_recording_is_read_alone(tmp_path):
    with profiling.recording():
        with profiling.span("first"):
            pass
    first = profiling.last_recording()

    def second():
        with profiling.span("second"):
            pass

    _profile(second, tmp_path)
    with profiling.span("between"):          # after the session: not kept
        pass
    second = profiling.last_recording()
    assert [s.label for s in first.spans] == ["first"]
    assert [s.label for s in second.spans] == ["second"]
    assert first.end_ns <= second.start_ns <= second.spans[0].start_ns <= second.end_ns


def test_batched_gkp_run_is_recorded_by_layer():
    from quantum_computations_tpu_torch.dv import State as DVState
    from quantum_computations_tpu_torch.dv import gates as dvg
    from quantum_computations_tpu_torch.gkp import MBGKPCircuit, db2eps
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs

    circ = MBGKPCircuit.transpile([dvg.H(0), dvg.CZ(0, 1), dvg.T(1)])
    circ.fill()
    runner = BatchedGKP(np.linspace(-12, 12, 96), db2eps(10.0),
                        dict(rel_err=1e-2, max_bond_dim=8), adaptive=True,
                        granularity="op", device="cpu")
    coeffs = logical_coeffs([DVState.ZERO] * 2)
    with profiling.recording():
        for seed in (1, 2):
            tensors, frames = runner.run_circuit(circ, coeffs, 2, rng_seed=seed)
            runner.readout(tensors, frames)
    rec = profiling.last_recording()
    rows = profiling.table()
    assert rows["run_circuit"]["calls"] == 2 and rows["readout"]["calls"] == 2
    for label in ("linalg:sketch", "linalg:eigh"):
        assert rows[label]["calls"] > 0
        assert len(rec.inside(label, "op:bs")) == rows[label]["calls"]
    for label in ("bs:contract", "bs:warp", "bs:svd"):
        assert len(rec.inside(label, "op:bs")) == rows[label]["calls"] == rows["op:bs"]["calls"]
    assert rows["op:synd_fetch"]["calls"] == runner.counts["fused_single"] > 0
    for label in ("fused:envs", "fused:first", "fused:second"):
        assert len(rec.inside(label, "op:fused_single")) == runner.counts["fused_single"]
    assert rows["fused:draw"]["calls"] == 2 * runner.counts["fused_single"]
    for s in rec.spans:
        if s.label.startswith("op:"):
            assert "run_circuit" in _ancestors(rec, s)


def _ancestors(rec, s):
    out = []
    while s.parent is not None:
        s = rec.spans[s.parent]
        out.append(s.label)
    return out
