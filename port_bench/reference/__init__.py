"""Plain reference of the benchmark's GKP trajectories (plain PyTorch and
NumPy; imports nothing of the port, of JAX or of the JAX package)."""
