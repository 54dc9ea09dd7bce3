"""Median host milliseconds of ``MaskRCNNResNet.predict_submit`` (prepare,
upload, dispatch) a request in the window."""

from port_bench import readers


def read(run):
    return readers.median_ms(run, "submit_s")
