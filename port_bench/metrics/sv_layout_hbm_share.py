"""Share of the card's memory bandwidth that the slab engine's layout
passes reached: the bytes their copies read and wrote (the engine's
``layout_bytes`` counter over the traced circuits) over the device time of
what its ``op:sv_layout`` spans launched, at 3.35 TB/s."""

from port_bench.metrics.slab_work import HBM_BYTES_PER_S, device_s, traced_sum


def read(run):
    nbytes, seconds = traced_sum(run, "layout_bytes"), device_s(run, "sv_layout")
    if nbytes is None or seconds is None:
        return None
    return nbytes / (seconds * HBM_BYTES_PER_S)
