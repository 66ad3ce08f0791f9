"""Host syncs per traced trajectory, cuSOLVER's and all others, as torch's
sync debug mode reports them (one client only)."""


def read(run):
    if run.syncs is None or not run.traced_trajectories:
        return None
    return (run.syncs["library"] + run.syncs["other"]) / run.traced_trajectories
