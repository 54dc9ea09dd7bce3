"""Median host milliseconds of ``mrcnn.backward`` a step in the traced
segment: the launch of ``autograd.grad``."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.backward")
