"""Independent users in an open loop: one image a request, Poisson
arrivals at the traffic's fixed ``rate``, served in arrival order through
``predict_collect(predict_submit([image]))``, which is ``predict``. Each
request is timed from when it was due, so a stall delays every request
queued behind it. Every request due inside the window is served, and its
latency counts, even when it finishes after the window closed; one still
unserved a minute after the close has failed."""

from __future__ import annotations

import math
import time

import numpy as np

from port_bench import trace, traffic
from port_bench.modes import serve

GRACE_S = 60.0


def setup(run):
    t = run.cell.traffic
    pool = [b[0] for b in traffic.serve_batches(t, run.seed, run.device)]
    shapes = [serve.padded(run.model, [img]) for img in pool]
    model = serve.build_model(run)
    serve.warm(model, [[img] for img in pool], shapes)
    run.state = {"model": model, "pool": pool, "shapes": shapes,
                 "served": {}}


def _serve(run, offsets, t0, close):
    """Serve the requests due at ``t0 + offsets`` (those due before
    ``close``) -> (latencies (s, inf if failed), submit seconds, flops,
    time of the last answer)."""
    st = run.state
    model = st["model"]
    lat, submit = [], []
    flops, last = 0, t0
    for i, off in enumerate(offsets):
        due = t0 + off
        if due >= close:
            break
        k = i % len(st["pool"])
        now = time.perf_counter()
        if now < due:
            with trace.span("wait_arrival"):
                time.sleep(due - now)
        if time.perf_counter() > close + GRACE_S:
            lat.append(float("inf"))
            continue
        ts = time.perf_counter()
        with trace.span("submit"):
            handle = model.predict_submit([st["pool"][k]])
        te = time.perf_counter()
        with trace.span("collect_paste"):
            res = model.predict_collect(handle)
        last = time.perf_counter()
        lat.append(last - due)
        submit.append(te - ts)
        st["served"].setdefault((k, 0), (st["pool"][k], st["shapes"][k],
                                         serve.per_image(res, 0)))
        n_dets = len(res[0][0])
        flops += run.cell.arch.predict_flops(run.model, *st["shapes"][k], 1,
                                             n_dets)
        if not serve.finite_result(res):
            lat[-1] = float("inf")
    return lat, submit, flops, last


def window(run, seconds, t0):
    offsets = traffic.arrivals(run.cell.traffic, seconds)
    lat, submit, flops, last = _serve(run, offsets, t0, t0 + seconds)
    run.attempted = len(lat)
    run.failed = sum(not np.isfinite(x) for x in lat)
    run.window = {"seconds": max(seconds, last - t0),
                  "units": len(lat) - run.failed, "flops": flops,
                  "latency_s": lat, "submit_s": submit}


def traced(run):
    seconds = run.cell.traffic["trace_seconds"]
    offsets = traffic.arrivals(run.cell.traffic, seconds)
    t0 = time.perf_counter()
    (lat, _, _, _), summary = trace.capture(
        lambda: _serve(run, offsets, t0, t0 + seconds), run.device)
    st = run.state
    shapes = [(st["shapes"][i % len(st["pool"])], 1)
              for i in range(len(lat))]
    run.trace = {"summary": summary,
                 "roofline": run.cell.arch.serve_rooflines(run, summary,
                                                           shapes)}


def release(run):
    cases = serve.sample_cases(run, run.state["served"])
    run.state = None
    return cases


def compare(run, cases):
    return serve.compare(run, cases)


def p95(latencies):
    """The 95th percentile of all the window's requests, failed ones
    counted as infinitely late."""
    lat = sorted(latencies)
    pos = 0.95 * (len(lat) - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if not math.isfinite(lat[hi]):
        return float("inf")
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)


def end_to_end(run):
    return {"serve_p95_ms": 1000.0 * p95(run.window["latency_s"])}
