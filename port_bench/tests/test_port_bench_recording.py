"""The readers of the port's span recorder on a synthetic recording and
synthetic busy intervals: the BS split's sketch and eigh host time, the
host's waits, and the device-idle time outside the engine threads."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.harness.bench import Run, load_module  # noqa: E402
from quantum_computations_tpu_torch.utils import profiling  # noqa: E402
from quantum_computations_tpu_torch.utils.profiling import Recording, Span  # noqa: E402

US = 1000  # ns per us: the synthetic stamps are in us, the trace clock their identity


def _recording():
    """Two engine threads over [0, 100] us. engine-0: run_circuit [5, 40]
    holding op:bs [10, 30] (linalg:sketch [11, 13], linalg:eigh [14, 20]
    and [22, 25]) and op:synd_fetch [32, 34]; readout [42, 45]; a
    linalg:eigh [50, 51] outside any op:bs. engine-1: run_circuit [30, 70]
    holding op:fused_pair_fetch[prerot] [60, 62] and op:rank1_fetch [64, 65]."""
    spans = []

    def add(label, thread, s, f, parent=None):
        spans.append(Span(label, thread, s * US, f * US, parent))
        return len(spans) - 1

    rc = add("run_circuit", "engine-0", 5, 40)
    bs = add("op:bs", "engine-0", 10, 30, rc)
    add("linalg:sketch", "engine-0", 11, 13, bs)
    add("linalg:eigh", "engine-0", 14, 20, bs)
    add("linalg:eigh", "engine-0", 22, 25, bs)
    add("op:synd_fetch", "engine-0", 32, 34, rc)
    add("readout", "engine-0", 42, 45)
    add("linalg:eigh", "engine-0", 50, 51)
    rc1 = add("run_circuit", "engine-1", 30, 70)
    add("op:fused_pair_fetch[prerot]", "engine-1", 60, 62, rc1)
    add("op:rank1_fetch", "engine-1", 64, 65, rc1)
    return Recording(0, 100 * US, spans)


@pytest.fixture
def run(monkeypatch):
    rec = _recording()
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    monkeypatch.setattr(profiling, "to_trace_us", lambda ns: ns / US)
    r = Run()
    r.traced_trajectories = 2
    # device busy [0, 8], [20, 35], [48, 55], [90, 100]; idle [8, 20],
    # [35, 48], [55, 90]
    r.trace = {"t0": 0.0, "t1": 100.0,
               "busy_intervals": [(0.0, 8.0), (20.0, 35.0), (48.0, 55.0), (90.0, 100.0)]}
    return r


def _read(name, run):
    return load_module(ROOT / "port_bench", "metrics", name).read(run)


def test_bs_split_host_time_counts_only_spans_inside_op_bs(run):
    assert _read("bs_sketch_host_ms.rb", run) == pytest.approx(2e-3 / 2)
    # the eigh at [50, 51] lies outside op:bs
    assert _read("bs_eigh_host_ms.rb", run) == pytest.approx(9e-3 / 2)
    assert _read("bs_eigh_host_ms.grover", run) == _read("bs_eigh_host_ms.rb", run)


def test_host_waits_count_fetches_and_eighs_of_every_thread(run):
    # three eighs, synd_fetch, fused_pair_fetch[prerot], rank1_fetch
    assert _read("host_waits_per_traj.rb", run) == pytest.approx(6 / 2)
    assert _read("host_waits_per_traj.rb_c4", run) == pytest.approx(6 / 2)


def test_idle_outside_the_engine_where_two_threads_overlap_a_gap(run):
    # engine intervals: [5, 40] and [30, 70] overlap into [5, 70]; readout
    # [42, 45] lies inside. Idle [8, 20] and [35, 48] are covered; of [55,
    # 90] the part [70, 90] is outside: 20 us over 2 trajectories.
    assert _read("idle_outside_engine_ms.rb_c4", run) == pytest.approx(20e-3 / 2)


def test_idle_outside_the_engine_with_one_thread(run, monkeypatch):
    rec = _recording()
    one = Recording(0, 100 * US, [s for s in rec.spans if s.thread == "engine-0"])
    monkeypatch.setattr(profiling, "last_recording", lambda: one)
    # engine [5, 40] and [42, 45]: idle outside them [40, 42] of [35, 48],
    # [45, 48], and [55, 90]: 2 + 3 + 35 us
    assert _read("idle_outside_engine_ms.rb_c4", run) == pytest.approx(40e-3 / 2)


@pytest.mark.parametrize("name", ["bs_sketch_host_ms.rb", "bs_eigh_host_ms.grover",
                                  "host_waits_per_traj.rb_c4", "idle_outside_engine_ms.rb_c4"])
def test_readers_give_nothing_without_a_recording(name, run, monkeypatch):
    untraced = Run()
    assert _read(name, untraced) is None                 # nothing traced
    monkeypatch.setattr(profiling, "last_recording", lambda: Recording(0, 1, []))
    assert _read(name, run) is None                      # an empty recording
    monkeypatch.delattr(profiling, "last_recording")
    assert _read(name, run) is None                      # a port without the recorder
