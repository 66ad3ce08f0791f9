"""The benchmark of the PyTorch/CUDA port (see PERF.md); run.py is its entry."""
