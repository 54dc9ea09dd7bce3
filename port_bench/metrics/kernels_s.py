"""Seconds of ``mrcnn.kernels_build`` (nvcc ran) or ``mrcnn.kernels_load`` in
set-up."""

from port_bench import spans


def read(run):
    return spans.total_s("mrcnn.kernels_build", "mrcnn.kernels_load")
