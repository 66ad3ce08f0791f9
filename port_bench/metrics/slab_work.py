"""The work of the slab engine's traced circuits, which its per-layer
metrics read (no metric of its own).

- The least time a slab window can take on one H100, whatever implements
  it: the split-real ``(R, d) @ (d, d)`` product over the 2^N amplitudes
  (R = 2^N / d rows) reads both float32 planes once and writes them once,
  16 R d bytes at the card's 3.35 TB/s, and takes 8 R d^2 operations (four
  real products) at its dense TF32 peak of 495 TFLOP/s (NVIDIA's data
  sheet, SXM part, 700 W); the bound is the larger. No window in place at
  FP32 accuracy beats it: 3xTF32 does three times the operations.
- The engine's layout counters over the traced circuits: ``engines/sv_slab``
  notes what its engine counted in each job it ran under the profiler
  (:func:`note`), and a reader sums the notes (:func:`traced_sum`). The
  notes live here because a reader sees only the run; ``make_engines``
  clears them at the start of each run. The windows are counted by the
  trace itself: one ``op:sv_window`` span a launch.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12

_notes: list[dict] = []


def window_bytes(N: int, d: int) -> int:
    """Bytes a slab window must move: both planes read and written once."""
    return 16 * ((1 << N) // d) * d


def window_flops(N: int, d: int) -> int:
    """Operations of a slab window's complex product: four real ones."""
    return 8 * ((1 << N) // d) * d * d


def window_bound_s(N: int, d: int) -> float:
    """The least seconds a window can take: bytes or operations at peak."""
    return max(window_bytes(N, d) / HBM_BYTES_PER_S, window_flops(N, d) / TF32_FLOP_PER_S)


def clear() -> None:
    _notes.clear()


def note(counts: dict) -> None:
    """Keep one traced job's counts: ``N``, ``d`` (the window's width),
    ``plane_copies``, ``layout_bytes``."""
    _notes.append(dict(counts))


def notes(run) -> list[dict] | None:
    """The traced jobs' notes, or None where nothing was traced or noted."""
    return list(_notes) if run.traced_trajectories and _notes else None


def traced_sum(run, key: str):
    """The sum of ``key`` over the traced jobs' notes, or None."""
    kept = notes(run)
    return sum(n[key] for n in kept) if kept else None


def device_s(run, span: str) -> float | None:
    """Device seconds of what the port launched inside its ``op:<span>``
    spans in the traced batches, or None where there is none."""
    if run.trace is None:
        return None
    row = run.trace["per_class"].get(span)
    return row["device_ms"] / 1e3 if row and row["device_ms"] > 0 else None
