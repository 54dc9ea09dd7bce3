"""Offline inference, the evaluator's sweep as ``engine/evaluator.py``
runs it: the traffic's pool of batches in order through
``MaskRCNNResNet.predict_submit``, one batch in flight while the next is
prepared and dispatched, each collected with ``predict_collect_raw``
(detections and their 14x14 mask probabilities, no paste: the evaluator
scores masks box-locally). The window counts the images whose results
came back before it closed. The comparison pastes the served
probabilities with the reference's paste, after the window."""

from __future__ import annotations

import contextlib
import time

from port_bench import trace, traffic
from port_bench.modes import serve
from port_bench.reference import model as R


def setup(run):
    t = run.cell.traffic
    batches = traffic.serve_batches(t, run.seed, run.device)
    shapes = [serve.padded(run.model, b) for b in batches]
    model = serve.build_model(run)
    for shape in sorted(set(shapes)):
        b = batches[shapes.index(shape)]
        model.predict_collect_raw(model.predict_submit(b))
    run.state = {"model": model, "batches": batches, "shapes": shapes,
                 "served": {}}


def _sweep(run, until, spans=False):
    """Sweep the pool in order until the host clock passes ``until`` ->
    ([(pool batch, raw result, time it came back)], images submitted)."""
    st = run.state
    model, batches = st["model"], st["batches"]

    def span(name):
        return trace.span(name) if spans else contextlib.nullcontext()

    out, pending, submitted, i = [], None, 0, 0
    while time.perf_counter() < until:
        b = i % len(batches)
        with span("submit"):
            handle = model.predict_submit(batches[b])
        submitted += len(batches[b])
        if pending is not None:
            with span("collect"):
                res = model.predict_collect_raw(pending[1])
            out.append((pending[0], res, time.perf_counter()))
        pending, i = (b, handle), i + 1
    if pending is not None:
        with span("collect"):
            res = model.predict_collect_raw(pending[1])
        out.append((pending[0], res, time.perf_counter()))
    return out, submitted


def window(run, seconds, t0):
    st = run.state
    deadline = t0 + seconds
    images = dets = 0
    flops = 0
    done, submitted = _sweep(run, deadline)
    for b, res, t in done:
        batch = st["batches"][b]
        for i, img in enumerate(batch):
            st["served"].setdefault(
                (b, i), (img, st["shapes"][b], serve.per_image(res, i)))
        if t > deadline:
            continue
        n_dets = sum(len(x) for x in res[0])
        images += len(batch)
        dets += n_dets
        flops += run.cell.arch.predict_flops(run.model, *st["shapes"][b],
                                             len(batch), n_dets)
        if not serve.finite_result(res):
            run.failed += len(batch)
    run.attempted = submitted
    run.window = {"seconds": seconds, "units": images, "flops": flops,
                  "detections": dets}


def traced(run):
    st = run.state
    seconds = run.cell.traffic["trace_seconds"]
    (done, _), summary = trace.capture(
        lambda: _sweep(run, time.perf_counter() + seconds, spans=True),
        run.device)
    shapes = [(st["shapes"][b], len(st["batches"][b])) for b, _, _ in done]
    run.trace = {"summary": summary,
                 "roofline": run.cell.arch.serve_rooflines(run, summary,
                                                           shapes)}


def release(run):
    cases = []
    for img, shape, (boxes, probs, labels, scores, size) in \
            serve.sample_cases(run, run.state["served"]):
        masks = R.paste(boxes, probs, *size)
        cases.append((img, shape, (boxes, masks, labels, scores)))
    run.state = None
    return cases


def compare(run, cases):
    return serve.compare(run, cases)


def end_to_end(run):
    return {"serve_images_per_s": run.window["units"]
            / run.window["seconds"]}

