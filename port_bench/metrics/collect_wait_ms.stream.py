"""Median host milliseconds of ``mrcnn.collect_wait`` a batch in the traced
segment: the copies back, where the host waits for the device (near 0 when
the host paces the stream)."""

from port_bench import spans


def read(run):
    return spans.median_ms("mrcnn.collect_wait")
