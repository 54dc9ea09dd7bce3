"""Median host milliseconds from the call of ``step_fn`` until it returns,
before the device finishes: the launch cost of a step."""

from port_bench import readers


def read(run):
    return readers.median_ms(run, "dispatch_s")
