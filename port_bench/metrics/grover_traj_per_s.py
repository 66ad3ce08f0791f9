"""Trajectories per second over the window, as ``rb_traj_per_s`` reads them."""

from port_bench.metrics.rb_traj_per_s import read  # noqa: F401
