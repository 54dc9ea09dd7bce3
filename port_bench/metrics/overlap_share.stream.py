"""Share of the traced segment's collects, in %, that returned while a later
batch still ran on the device: the port's ``mrcnn.collect_overlapped``
count over its ``mrcnn.collect_wait`` spans. A collect that waits for its
own batch alone leaves the next one queued, so the device stays busy while
the host thresholds and prepares; a collect that drains the stream leaves
it idle. A port that keeps no counts gives None."""

from port_bench import spans


def read(run):
    profiling = spans._recorded()
    if profiling is None or not hasattr(profiling, "counters"):
        return None
    waits = sum(s.name == "mrcnn.collect_wait" for s in profiling.spans())
    if not waits:
        return None
    overlapped = profiling.counters().get("mrcnn.collect_overlapped", 0)
    return 100.0 * overlapped / waits
