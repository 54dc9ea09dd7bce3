"""RoIAlign backward (K7) in the traced segment: its byte floor over its device
time."""

from port_bench import readers


def read(run):
    return readers.roofline(run, "roi_align_bwd")
