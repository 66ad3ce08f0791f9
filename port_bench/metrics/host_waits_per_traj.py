"""The host's waits on the device per traced trajectory, over every engine
thread: the port's ``*_fetch`` spans (the engine's device-to-host copies of
outcomes and ranks, whatever their bracketed path) and its ``linalg:eigh``
spans (cuSOLVER's info check), counted from the port's span recorder."""

from port_bench.metrics.bs_sketch_host_ms import recording


def is_wait(label: str) -> bool:
    return label == "linalg:eigh" or label.split("[")[0].endswith("_fetch")


def read(run):
    rec = recording(run)
    if rec is None:
        return None
    return sum(is_wait(s.label) for s in rec.spans) / run.traced_trajectories
