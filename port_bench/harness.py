"""One run of one cell: set-up, the measured window, the traced segment,
the comparison, and the result line. ``run.py`` is its command line.

What a run holds for the per-layer readers (``metrics/<name>.py``):

* ``run.window``: ``seconds`` (host clock, start to end of the window),
  ``units`` (images, requests or steps completed in it), ``flops``
  (their analytic count, the architecture's ``predict_flops`` or
  ``train_flops``) and the mode's own host-clock readings;
* ``run.trace``: the summary of the traced segment (``trace.reduce``)
  and its ``roofline`` entries, ``{kernel: (floor seconds, device
  seconds)}``, from the architecture's ``serve_rooflines`` or
  ``train_rooflines``.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from port_bench import check, counts, spec
from port_bench.trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "mask_rcnn_tpu")


class Run:
    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 traced: bool, device, t_start: float):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = torch.device(device)
        self.t_start = t_start
        self.model = cell.config["model"]
        self.state = None
        self.window = {}
        self.trace = {}
        self.attempted = 0
        self.failed = 0

    @property
    def peaks(self):
        if self.device.type != "cuda":
            return None
        return counts.CARDS.get(torch.cuda.get_device_name(self.device))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device):
    """(platform, kind, count) of the run's device."""
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device), 1
    return "cpu", "cpu", 1


def execute(run: Run):
    """Set-up, window, traced segment and comparison -> the result dict,
    with the compared rows under ``checks``."""
    mode = spec.mode(run.cell)
    dev = run.device
    mode.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    mode.window(run, run.seconds, t0)
    if run.traced:
        mode.traced(run)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    evidence = mode.release(run)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = mode.compare(run, evidence)
    correct, rows = check.verdict(numbers, run.cell.limits)
    correct = correct and run.failed == 0

    metrics = {}
    if run.traced:
        for m in run.cell.per_layer:
            value = spec.reader(run.cell, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(mode.end_to_end(run), setup_s=setup_s)
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    platform, kind, count = card(dev)
    device = {"platform": platform, "kind": kind, "count": count,
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace["summary"]["busy_s"]
        device["window_s"] = run.trace["summary"]["window_s"]
        result["breakdown"] = breakdown(run.trace["summary"])
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    result["compared"] = {k: v for k, v in numbers.items()
                          if k not in result["checks"]}
    return result


def emit(result):
    """The comparison's numbers beside their limits as the last lines of
    stderr, then the result line (its ``checks`` key last) on stdout."""
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
