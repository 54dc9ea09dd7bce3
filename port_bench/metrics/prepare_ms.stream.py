"""Median host milliseconds of ``mrcnn.prepare`` a batch in the traced
segment: resize, pinned upload and mean of each image."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.prepare")
