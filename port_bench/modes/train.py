"""The train step: the ``step_fn`` of ``engine/trainer.py::make_train_step``,
the function ``train()`` calls each step, on a pool of padded batches kept
on the device, with the sampling priorities of each step drawn from the
seed and handed in. Set-up builds the one train state, drives it through
one step on each pool batch (so every shape is warmed) and keeps, as the
program's output for the comparison, the first three steps' losses, the
velocity after step 1 and the trainable weights after step 3; the window
goes on from that state."""

from __future__ import annotations

import contextlib
import time

import torch

from port_bench import check, trace, traffic, weights
from port_bench.reference import model as R
from port_bench.reference import train as RT

COMPARED_STEPS = 3


def _sizes(run, batch):
    mc = run.model
    n, h, w = batch["image"].shape[:3]
    cand = mc["proposal"]["n_train_post_nms"] + batch["bbox"].shape[1]
    return n, h, w, run.cell.arch.anchor_count(mc, h, w), cand


def _priorities(run, step, batch):
    n, _, _, n_anchor, n_cand = _sizes(run, batch)
    return traffic.priorities(run.cell.traffic, run.seed, step, n, n_anchor,
                              n_cand, run.device)


def setup(run):
    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
    )
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    tr, arch = run.cell.config["train"], run.cell.arch
    params = weights.of_config(arch, run.cell.config, run.device)
    opt, _ = make_optimizer(params, tr["lr"], tr["total_steps"],
                            momentum=tr["momentum"],
                            weight_decay=tr["weight_decay"])
    state = create_train_state(params, opt)
    step_fn = make_train_step(
        arch.port_config(run.model), opt,
        proposal_cfg=ProposalTargetConfig(**tr["proposal_target"]),
        anchor_cfg=AnchorTargetConfig(**tr["anchor_target"]))
    batches = traffic.train_batches(run.cell.traffic, run.model, run.seed,
                                    run.device)
    evidence = {"losses": []}
    for k, batch in enumerate(batches):
        state, met = step_fn(state, batch, _priorities(run, k, batch))
        if k < COMPARED_STEPS:
            evidence["losses"].append(met)
        if k == 0:
            evidence["v1"] = {n: v.detach().clone() for n, v in
                              flatten_params(state.momentum).items()}
        if k == COMPARED_STEPS - 1:
            evidence["w3"] = {n: flatten_params(state.params)[n].detach()
                              .clone() for n in evidence["v1"]}
    evidence["losses"] = [{k: float(v) for k, v in met.items()}
                          for met in evidence["losses"]]
    run.state = {"state": state, "step_fn": step_fn, "batches": batches,
                 "step": len(batches), "evidence": evidence}


def _steps(run, until, spans=False):
    """Steps on the pool in order until the host clock passes ``until``;
    -> (losses, host seconds of each ``step_fn`` call, flops)."""
    st = run.state
    losses, dispatch, flops = [], [], 0
    while time.perf_counter() < until:
        batch = st["batches"][st["step"] % len(st["batches"])]
        with trace.span("priorities") if spans else contextlib.nullcontext():
            pri = _priorities(run, st["step"], batch)
        t = time.perf_counter()
        with trace.span("step_fn") if spans else contextlib.nullcontext():
            st["state"], met = st["step_fn"](st["state"], batch, pri)
        dispatch.append(time.perf_counter() - t)
        losses.append(met["loss"])
        n, h, w, _, _ = _sizes(run, batch)
        flops += run.cell.arch.train_flops(run.model,
                                           run.cell.config["train"], h, w, n)
        st["step"] += 1
    return losses, dispatch, flops


def window(run, seconds, t0):
    losses, dispatch, flops = _steps(run, t0 + seconds)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    ok = torch.isfinite(torch.stack(losses)).cpu()
    n = run.state["batches"][0]["image"].shape[0]
    run.attempted = len(losses)
    run.failed = int((~ok).sum())
    run.window = {"seconds": elapsed, "units": n * int(ok.sum()),
                  "flops": flops, "dispatch_s": dispatch}


def traced(run):
    seconds = run.cell.traffic["trace_seconds"]
    (losses, _, _), summary = trace.capture(
        lambda: _steps(run, time.perf_counter() + seconds, spans=True),
        run.device)
    run.trace = {"summary": summary,
                 "roofline": run.cell.arch.train_rooflines(
                     run, summary, len(losses), run.state["batches"][0])}


def release(run):
    evidence = run.state["evidence"]
    evidence["batches"] = run.state["batches"][:COMPARED_STEPS]
    run.state = None
    return evidence


def compare(run, evidence):
    R.full_precision()
    cfg, tr, arch = run.cell.config, run.cell.config["train"], run.cell.arch
    w0 = RT.flatten(weights.of_config(arch, cfg, run.device))
    params = weights.of_config(arch, cfg, run.device)
    batches = evidence["batches"]
    pri = [_priorities(run, k, b) for k, b in enumerate(batches)]
    losses, g1, w3 = check.reference_steps(arch, cfg, params, batches, pri)
    ref = {"losses": losses, "grad": g1, "w3": w3}
    prog = {"losses": evidence["losses"], "w3": evidence["w3"],
            "grad": {k: v / -tr["lr"] - tr["weight_decay"] * w0[k]
                     for k, v in evidence["v1"].items()}}
    return check.train_numbers(w0, ref, prog)


def end_to_end(run):
    return {"train_images_per_s": run.window["units"]
            / run.window["seconds"]}
