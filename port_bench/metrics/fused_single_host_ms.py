"""Host milliseconds inside the port's ``op:fused_single`` spans per traced
trajectory (dispatch, and whatever the span waits for)."""


def read(run):
    if run.trace is None or not run.traced_trajectories:
        return None
    row = run.trace["per_class"].get("fused_single")
    return row["host_ms"] / run.traced_trajectories if row else None
