"""Median host milliseconds of ``mrcnn.forward`` a step in the traced
segment: the launch of ``train_loss``."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.forward")
