"""The readings that the limits of ``limits/<cell>.json`` are set from;
the benchmark's own runs never run this. In one process:

* the program on each of ``--seeds`` (a short window, then the same
  comparison as a run);
* the control on each of ``--control-seeds``: the reference, computed on
  float8 operands, put in the program's place and judged by the float32
  reference, at the cell's own sizes;
* with ``--faults``, the program with one fault planted under the timed
  path, on each control seed: ``half`` (half of each batch left out),
  ``alter`` (one answer altered where it is produced; serving cells),
  ``unchanged`` (the step returns its state unchanged; train cells).

    python3 -m port_bench.calibrate --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults half,alter] [--seconds 2]

With ``--rates 8,10,12`` it instead sweeps an open-loop cell's offered
rate on one set-up (the first of ``--seeds``), ``--seconds`` a rate.

One JSON line a reading on stdout (``kind``, ``seed``, the numbers).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from port_bench import check, harness, spec, traffic, weights
from port_bench.modes import serve
from port_bench.reference import model as R
from port_bench.traffic import rng


# ---------------------------------------------------------------------------
# The control: the reference in float8 in the program's place


def serve_control(cell, seed, device):
    """The numbers of the float8 reference's answers on ``check_images``
    images of the seed's pool."""
    t, mc, arch = cell.traffic, cell.config["model"], cell.arch
    batches = traffic.serve_batches(t, seed, device)
    R.full_precision()
    params = weights.of_config(arch, cell.config, device)
    keys = [(b, i) for b, batch in enumerate(batches)
            for i in range(len(batch))]
    pick = rng(seed, 7).choice(len(keys), min(t["check_images"], len(keys)),
                               replace=False)
    cases = []
    with torch.no_grad():
        for k in sorted(pick):
            b, i = keys[k]
            img, shape = batches[b][i], serve.padded(mc, batches[b])
            d = arch.detect(params, mc, img, shape, R.FP8, device)
            probs = arch.mask_probs(params, mc, d["features"], d["boxes"],
                                    d["labels"], d["scale"], R.FP8)
            boxes = d["boxes"].cpu().numpy()
            masks = R.paste(boxes, probs.cpu().numpy(), *img.shape[1:])
            cases.append((img, shape, (boxes, masks,
                                       d["labels"].cpu().numpy().astype(
                                           "int32"),
                                       d["scores"].cpu().numpy())))
    return check.serve_numbers(arch, params, mc, cases)


def train_control(cell, seed, device):
    """The numbers of the float8 reference's first three steps."""
    from port_bench.modes import train as td
    from port_bench.reference import train as RT

    cfg, mc = cell.config, cell.config["model"]
    run = harness.Run(cell, seed, 0, False, device, time.perf_counter())
    batches = traffic.train_batches(cell.traffic, mc, seed,
                                    device)[:td.COMPARED_STEPS]
    pri = [td._priorities(run, k, b) for k, b in enumerate(batches)]
    R.full_precision()
    w0 = RT.flatten(weights.of_config(cell.arch, cfg, device))
    runs = {}
    for name, prec in (("ref", R.FULL), ("prog", R.FP8)):
        params = weights.of_config(cell.arch, cfg, device)
        losses, g1, w3 = check.reference_steps(cell.arch, cfg, params,
                                               batches, pri, prec)
        runs[name] = {"losses": losses, "grad": g1, "w3": w3}
    return check.train_numbers(w0, runs["ref"], runs["prog"])


# ---------------------------------------------------------------------------
# Faults planted under the timed path


@contextlib.contextmanager
def fault(kind, mode):
    """Plant fault ``kind`` in the port for a cell of ``mode``."""
    from mask_rcnn_tpu_torch.engine import trainer
    from mask_rcnn_tpu_torch.models import api

    if mode == "train" and kind == "half":
        original, target, attr = trainer.train_loss, trainer, "train_loss"

        def planted(params, cfg, batch, pri, **kw):
            n = batch["image"].shape[0] // 2
            half = {k: v[:n] for k, v in batch.items()}
            pri = {k: tuple(p[:n] for p in v) for k, v in pri.items()}
            return original(params, cfg, half, pri, **kw)
    elif mode == "train" and kind == "unchanged":
        original, target, attr = (trainer.MomentumSGD.apply,
                                  trainer.MomentumSGD, "apply")

        def planted(self, params, momentum, grads, step):
            return None
    elif mode != "train" and kind in ("half", "alter"):
        original, target, attr = api.predict_step, api, "predict_step"

        def planted(*args):
            out = dict(original(*args))
            if kind == "half":
                keep = torch.arange(out["valid"].shape[0],
                                    device=out["valid"].device) % 2 == 0
                out["valid"] = out["valid"] & keep[:, None]
            else:
                out["scores"] = out["scores"].clone()
                out["scores"][:, 0] += 0.05
            return out
    else:
        raise ValueError(f"no fault {kind!r} for a {mode} cell")
    setattr(target, attr, planted)
    try:
        yield
    finally:
        setattr(target, attr, original)


def program(cell, seed, seconds, device):
    run = harness.Run(cell, seed, seconds, False, device, time.perf_counter())
    result = harness.execute(run)
    return {k: c["value"] for k, c in result["checks"].items()} | \
        result["compared"] | {"failed": result["failed"],
                              "attempted": result["attempted"]}


def sweep(cell, seed, rates, seconds, device):
    """An open-loop cell's latency at each offered rate, on one set-up:
    the 95th percentile, and the median latency of the window's last
    quarter of requests against its first (a backlog that grows reads
    well above 1)."""
    from port_bench.modes import online

    run = harness.Run(cell, seed, seconds, False, device, time.perf_counter())
    online.setup(run)
    for rate in rates:
        run.cell.traffic["rate"] = rate
        online.window(run, seconds, time.perf_counter())
        lat = run.window["latency_s"]
        q = max(1, len(lat) // 4)
        yield {"rate": rate, "requests": len(lat),
               "p95_ms": 1000 * online.p95(lat),
               "median_ms": 1000 * sorted(lat)[len(lat) // 2],
               "growth": (sorted(lat[-q:])[q // 2]
                          / sorted(lat[:q])[q // 2])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", default="",
                   help="sweep these offered rates (open-loop cells)")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(kind, seed, numbers):
        print(json.dumps({"kind": kind, "seed": seed, **numbers}),
              flush=True)

    rates = [float(r) for r in args.rates.split(",") if r]
    for reading in sweep(cell, (seeds or [0])[0], rates, args.seconds,
                         args.device) if rates else ():
        emit("sweep", (seeds or [0])[0], reading)
    if rates:
        return 0
    for s in seeds:
        emit("program", s, program(cell, s, args.seconds, args.device))
    control = train_control if cell.mode == "train" else serve_control
    for s in controls:
        emit("control", s, control(cell, s, args.device))
    for kind in [k for k in args.faults.split(",") if k]:
        for s in controls:
            with fault(kind, cell.mode):
                emit("fault:" + kind, s,
                     program(cell, s, args.seconds, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
