"""Plain references of the port's engines: straightforward PyTorch and
numpy that import nothing of the port and nothing of JAX, for the tests
and the benchmark to hold the engines against."""
