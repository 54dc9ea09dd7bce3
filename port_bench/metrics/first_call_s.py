"""Seconds of the process's ``mrcnn.first_call`` spans less their child spans
(the kernels' build or load inside the first): the host's share of each
padded shape's first call in set-up."""

from port_bench import spans


def read(run):
    return spans.self_s("mrcnn.first_call")
