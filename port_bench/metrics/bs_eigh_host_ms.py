"""Host milliseconds inside the port's ``linalg:eigh`` spans (each
``torch.linalg.eigh``: its dispatch and cuSOLVER's info-check wait) that
lie inside an ``op:bs`` span, per traced trajectory, summed over threads;
from the port's span recorder."""

from port_bench.metrics.bs_sketch_host_ms import host_ms_inside


def read(run):
    return host_ms_inside(run, "linalg:eigh")
