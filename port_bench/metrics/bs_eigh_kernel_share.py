"""Share of the Gram eigendecompositions inside ``op:bs`` spans (the
materialised beamsplitter split) that ran on the port's one-launch Jacobi
kernel (``linalg:eigh_small`` spans) rather than on ``torch.linalg.eigh``
(``linalg:eigh`` spans): a count over the traced batches and every thread,
from the port's span recorder; 0.0 on a port without the kernel."""

from port_bench.metrics.bs_sketch_host_ms import recording


def read(run):
    rec = recording(run)
    if rec is None:
        return None
    small = len(rec.inside("linalg:eigh_small", "op:bs"))
    library = len(rec.inside("linalg:eigh", "op:bs"))
    return small / (small + library) if small + library else None
