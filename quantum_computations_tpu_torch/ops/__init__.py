"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version (the CPU path and the kernel's reference)."""
