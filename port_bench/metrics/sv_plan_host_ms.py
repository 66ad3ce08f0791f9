"""Host milliseconds inside the slab engine's ``op:sv_plan`` spans (fusion,
the window planner, the recorded plan and its window uploads) per traced
circuit."""


def read(run):
    if run.trace is None or not run.traced_trajectories:
        return None
    row = run.trace["per_class"].get("sv_plan")
    return row["host_ms"] / run.traced_trajectories if row else None
