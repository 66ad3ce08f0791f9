"""Metric readers, one module per metric of BENCHMARK.json: ``read(run)``
returns the metric's value, or None where its source was not taken."""
