"""The reader of ``bs_eigh_kernel_share`` on a synthetic recording: the
share of the Gram eigendecompositions inside ``op:bs`` that ran on the
port's one-launch kernel, 0.0 where every one ran on the library, and
nothing where there is nothing to read."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.harness.bench import Run, load_module  # noqa: E402
from quantum_computations_tpu_torch.utils import profiling  # noqa: E402
from quantum_computations_tpu_torch.utils.profiling import Recording, Span  # noqa: E402


def _recording():
    """engine-0: op:bs [10, 30] holding bs:svd [11, 29], which holds three
    linalg:eigh_small [12, 13], [14, 15], [16, 17] and one linalg:eigh [20,
    25]; a linalg:eigh_small [40, 41] and a linalg:eigh [50, 51] outside any
    op:bs."""
    spans = []

    def add(label, s, f, parent=None):
        spans.append(Span(label, "engine-0", s, f, parent))
        return len(spans) - 1

    bs = add("op:bs", 10, 30)
    svd = add("bs:svd", 11, 29, bs)
    for s in (12, 14, 16):
        add("linalg:eigh_small", s, s + 1, svd)
    add("linalg:eigh", 20, 25, svd)
    add("linalg:eigh_small", 40, 41)
    add("linalg:eigh", 50, 51)
    return Recording(0, 100, spans)


def _read(name, run):
    return load_module(ROOT / "port_bench", "metrics", name).read(run)


@pytest.fixture
def run(monkeypatch):
    rec = _recording()
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    r = Run()
    r.traced_trajectories = 2
    return r


@pytest.mark.parametrize("name", ["bs_eigh_kernel_share.rb", "bs_eigh_kernel_share.grover"])
def test_share_counts_only_calls_inside_op_bs(name, run):
    assert _read(name, run) == pytest.approx(3 / 4)


def test_share_gives_nothing_where_there_is_nothing_to_read(run, monkeypatch):
    assert _read("bs_eigh_kernel_share.rb", Run()) is None            # nothing traced
    monkeypatch.setattr(profiling, "last_recording", lambda: Recording(0, 1, []))
    assert _read("bs_eigh_kernel_share.rb", run) is None              # an empty recording
    monkeypatch.setattr(profiling, "last_recording",
                        lambda: Recording(0, 1, [Span("op:bs", "engine-0", 0, 1, None)]))
    assert _read("bs_eigh_kernel_share.rb", run) is None              # no eigh in op:bs


def test_share_reads_zero_where_every_eigh_ran_on_the_library(run, monkeypatch):
    """A port without the kernel records only ``linalg:eigh`` in op:bs."""
    rec = Recording(0, 10, [Span("op:bs", "engine-0", 0, 9, None),
                            Span("linalg:eigh", "engine-0", 1, 2, 0),
                            Span("linalg:eigh", "engine-0", 3, 4, 0)])
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    assert _read("bs_eigh_kernel_share.rb", run) == 0.0
