"""Seconds from the start of the run to the first timed batch: imports,
engines and grid tables, and one warm batch per client."""


def read(run):
    return run.setup_s
