"""What the per-layer readers (``metrics/<name>.py``) share. Each returns
None when the run holds nothing for it to read."""

from __future__ import annotations

import statistics


def median_ms(run, key):
    values = run.window.get(key)
    return 1000.0 * statistics.median(values) if values else None


def mfu(run):
    """Analytic FLOPs of the window's completed work over its seconds, as
    a share of the card's dense bf16 peak."""
    peaks = run.peaks
    if not peaks or not run.window.get("flops"):
        return None
    return 100.0 * run.window["flops"] / run.window["seconds"] / \
        peaks["flops"]["bf16"]


def roofline(run, kernel):
    """The kernel's floor over its device time in the traced segment."""
    floor, seconds = run.trace.get("roofline", {}).get(kernel, (None, 0))
    if floor is None or not seconds:
        return None
    return 100.0 * floor / seconds


def idle_share(run):
    s = run.trace.get("summary")
    if not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
