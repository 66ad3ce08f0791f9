"""The harness of the port's benchmark: cells, the closed loop, draws, traces, syncs and the check."""
