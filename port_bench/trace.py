"""The traced segment: one ``torch.profiler`` capture of CPU and CUDA
activity around a run of the cell's traffic, checked for lost records,
reduced to what the per-layer readers take.

The harness marks what the host is doing with ``record_function`` spans
named ``bench.<what>`` from its own files, around its calls into the
program. The device's idle gaps are labelled with the innermost such span
that holds the gap's middle.
"""

from __future__ import annotations

import bisect
import collections

import torch

MARK = "bench.traced"
SPAN = "bench."
# Host calls that each put one activity on the device
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
            "cuMemset")
NO_DEVICE_ACTIVITY = ("cudaLaunchHostFunc",)
# Launches to spare on each side of the mark: the profiler has been seen to
# drop device records at a capture's edges.
SPARE = 64


def span(name):
    from torch.profiler import record_function
    return record_function(SPAN + name)


def _spare(device):
    x = torch.zeros(1, device=device)
    for _ in range(SPARE):
        x.add_(1.0)
    torch.cuda.synchronize(device)


def capture(fn, device):
    """Run ``fn()`` inside one capture; -> (its result, :func:`reduce`'s
    summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _spare(device)
        with record_function(MARK):
            out = fn()
            torch.cuda.synchronize(device)
        _spare(device)
    return out, reduce(prof.profiler.kineto_results.events())


def reduce(events):
    """The capture's activities inside the mark: busy and window seconds,
    device seconds and activity counts by name, and idle seconds by host
    span. Raises when a launch inside the mark lost its device record."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = collections.defaultdict(list), []
    for ev in events:
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device[ev.correlation_id()].append(
                    (ev.start_ns(), ev.end_ns(), ev.name()))
        else:
            host.append((ev.start_ns(), ev.end_ns(), ev.name(),
                         ev.correlation_id()))
    marks = [h for h in host if h[2] == MARK]
    if len(marks) != 1:
        raise RuntimeError(f"profiler capture holds {len(marks)} marks")
    lo, hi = marks[0][:2]
    launches = [h for h in host if lo <= h[0] <= hi
                and h[2].startswith(LAUNCHES)
                and not h[2].startswith(NO_DEVICE_ACTIVITY)]
    lost = [h[2] for h in launches if h[3] not in device]
    if lost or not launches:
        raise RuntimeError(f"short profiler capture: {len(lost)} of "
                           f"{len(launches)} launches have no device record "
                           f"({sorted(set(lost))[:6]})")
    acts = sorted(a for h in launches for a in device[h[3]])
    by_name = collections.defaultdict(float)
    counts = collections.Counter()
    for a in acts:
        by_name[a[2]] += (a[1] - a[0]) / 1e9
        counts[a[2]] += 1
    busy, gaps, end = 0, [], lo
    for start, stop, _ in acts:
        if start > end:
            gaps.append((end, start))
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    if hi > end:
        gaps.append((end, hi))
    spans = sorted(h for h in host if h[2].startswith(SPAN) and h[2] != MARK)
    starts = [s[0] for s in spans]
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        label = "between spans"
        # the innermost span holding mid starts last among those that do
        for s in reversed(spans[max(0, bisect.bisect_right(starts, mid) - 64):
                                bisect.bisect_right(starts, mid)]):
            if s[1] >= mid:
                label = s[2][len(SPAN):]
                break
        idle[label] += (g1 - g0) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "device_s": dict(by_name), "device_count": dict(counts),
            "idle_s": dict(idle), "launches": len(launches)}


def kernel(summary, name):
    """(seconds, activities) of the device activities whose name holds
    ``name``."""
    keys = [k for k in summary["device_s"] if name in k]
    return (sum(summary["device_s"][k] for k in keys),
            sum(summary["device_count"][k] for k in keys))


def breakdown(summary, top=10):
    ops = sorted(summary["device_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k[:200], v] for k, v in gaps]}
