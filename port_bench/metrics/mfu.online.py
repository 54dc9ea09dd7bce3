"""Analytic FLOPs of the requests served in the window over its seconds, as a
share of the bf16 peak."""

from port_bench import readers


def read(run):
    return readers.mfu(run)
