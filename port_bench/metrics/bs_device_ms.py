"""Device milliseconds of the kernels, copies and fills launched inside the
port's ``op:bs`` spans (the materialised beamsplitter split) per traced
trajectory; attribution by launch time assumes one client."""


def read(run):
    if run.trace is None or not run.traced_trajectories:
        return None
    row = run.trace["per_class"].get("bs")
    return row["device_ms"] / run.traced_trajectories if row else None
