"""What the readers of the port's own spans share: the ``mrcnn.<what>``
spans that ``mask_rcnn_tpu_torch.utils.profiling`` keeps in the process.
The set-up spans are always recorded; the hot path's only while a
profiler runs, so here only from the traced segment. A port that keeps no
spans gives None."""

from __future__ import annotations

import statistics


def _recorded():
    from mask_rcnn_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    return profiling


def median_ms(name):
    """Median milliseconds of the spans named ``name``."""
    profiling = _recorded()
    if profiling is None:
        return None
    ns = [s.end_ns - s.start_ns for s in profiling.spans() if s.name == name]
    return statistics.median(ns) / 1e6 if ns else None


def total_s(*names):
    """Seconds of all the spans named one of ``names``."""
    profiling = _recorded()
    if profiling is None:
        return None
    ns = [s.end_ns - s.start_ns for s in profiling.spans()
          if s.name in names]
    return sum(ns) / 1e9 if ns else None


def self_s(name):
    """Seconds of the spans named ``name`` less what their child spans
    cover."""
    profiling = _recorded()
    if profiling is None:
        return None
    ns = profiling.self_times_ns(name)
    return sum(ns) / 1e9 if ns else None
