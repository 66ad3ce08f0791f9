"""Device-idle milliseconds per traced trajectory during which no engine
thread was inside ``run_circuit`` or ``readout``: drawing the next job,
copying and scoring the densities, and waiting on other clients. The idle
time is the complement of the device's busy intervals in the traced window
(``run.trace``); the port's spans, every thread's, come from its span
recorder and are put on the trace's clock by ``utils.profiling.to_trace_us``."""

from port_bench.metrics.bs_sketch_host_ms import recording

ENGINE = ("run_circuit", "readout")


def merged(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, f in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], f)
        else:
            out.append([s, f])
    return out


def gaps(busy, t0: float, t1: float):
    """The complement of sorted, disjoint ``busy`` intervals in [t0, t1]."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    return [(s, f) for s, f in zip(edges[::2], edges[1::2]) if f > s]


def overlap(a, b) -> float:
    """The measure of the intersection of two sorted, disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    rec = recording(run)
    if rec is None or run.trace is None:
        return None
    from quantum_computations_tpu_torch.utils.profiling import to_trace_us

    idle = gaps(run.trace["busy_intervals"], run.trace["t0"], run.trace["t1"])
    engine = merged((to_trace_us(s.start_ns), to_trace_us(s.end_ns))
                    for s in rec.spans if s.label in ENGINE)
    outside_us = sum(f - s for s, f in idle) - overlap(idle, engine)
    return outside_us / 1e3 / run.traced_trajectories
