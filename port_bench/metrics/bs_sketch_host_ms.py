"""Host milliseconds inside the port's ``linalg:sketch`` spans (the range
finder's host Gaussian sketches and their copies to the device) that lie
inside an ``op:bs`` span (the materialised beamsplitter split), per traced
trajectory, summed over threads. Read from the port's span recorder
(``utils.profiling.last_recording``): the spans of the traced batches."""


def recording(run):
    """The port's last recording, which holds the traced batches of a
    ``--trace 1`` run; None where nothing was traced, the port has no
    recorder, or the recording holds no span."""
    if not run.traced_trajectories:
        return None
    from quantum_computations_tpu_torch.utils import profiling

    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    return rec if rec is not None and rec.spans else None


def host_ms_inside(run, label: str, ancestor: str = "op:bs"):
    """Host ms per traced trajectory in the spans ``label`` inside an
    ``ancestor`` span of their thread."""
    rec = recording(run)
    if rec is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec.inside(label, ancestor))
    return ns / 1e6 / run.traced_trajectories


def read(run):
    return host_ms_inside(run, "linalg:sketch")
