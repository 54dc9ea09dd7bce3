"""Median host milliseconds of ``mrcnn.predict_step`` a batch in the traced
segment: the launch of the model step."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.predict_step")
