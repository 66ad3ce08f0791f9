"""Trajectories completed in the window (all clients, failed ones left
out) over the window's seconds: all the work of the window, readout to the
host and scoring included."""


def read(run):
    return run.trajectories / run.window_s if run.window_s > 0 else None
