"""Median host milliseconds of ``mrcnn.update`` a step in the traced
segment: the masked MomentumSGD."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.update")
