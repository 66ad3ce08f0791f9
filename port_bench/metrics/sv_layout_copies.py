"""Plane copies that the slab engine's layout passes made per traced
circuit: its ``plane_copies`` counter over the jobs run under the profiler
(``slab_work.note``)."""

from port_bench.metrics.slab_work import traced_sum


def read(run):
    copies = traced_sum(run, "plane_copies")
    return copies / run.traced_trajectories if copies is not None else None
