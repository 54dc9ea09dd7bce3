"""Share of the traced segment in which no activity ran on the device."""

from port_bench import readers


def read(run):
    return readers.idle_share(run)
