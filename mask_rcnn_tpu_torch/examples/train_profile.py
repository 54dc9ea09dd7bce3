"""Per-stage train-step profile of R-50/101-C4 at COCO scale on one card,
the port of ``examples/train_profile.py``.

Splits the batch-2 832x1344 train step into its stages: the backbone + RPN
forward (the stem is kernel K10), proposal NMS 12000 -> 2000 an image (K2),
the proposal targets (K9b) and the anchor targets (K9a), the RoI head
forward (RoIAlign K1 + res5 + the box and mask branches), the backbone
forward+backward, the head forward+backward (its RoIAlign backward is K7:
the features' gradient is taken too, as the train step needs it), the
forward loss, and forward+backward; then the full step
(``utils/profiling.py::time_train_steps_chained``) and three derived
rows. Each stage is timed chained on the device timeline
(``time_fn_chained``: the union of device activity, without the host's
dispatch gaps) and by CUDA events of back-to-back calls (the host-paced
time), with FLOPs and bytes from ``cost_of`` (the hand kernels' reports
included).

In eager torch nothing fuses across the stage boundaries (the JAX
script's caveat about XLA fusion does not hold): each stage runs the ops
it runs inside the step. The table reads the sum of the parts that make up
a step (backbone fwd+bwd, proposals, both target creators, head
fwd+bwd) against the full step's device ms; the rest is the losses, the
casts and the optimizer.

    python -m mask_rcnn_tpu_torch.examples.train_profile \\
        [--batch 2] [--dtype bfloat16] [--layers 50]

Columns: device ms, events ms, GFLOP, TFLOP/s on device time, MFU against
the card's bf16 peak, GB, the roofline floor at the dtype's peak (float32:
the CUDA cores' 67 TFLOP/s, the port runs float32 without TF32) with its
bound, and the floor's share of the device ms. Entry points run on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mask_rcnn_tpu_torch.examples import _profile_common as common


def run(batch_size=2, dtype="bfloat16", iters=6, reps=10, layers=50,
        device="cuda", batch=None, proposal_cfg=None, **overrides):
    """Prints the table; returns the rows (stages, then the full step).
    ``batch`` (numpy arrays) replaces the synthetic 832x1344 batch,
    ``proposal_cfg`` the sampler's defaults, ``overrides`` fields of the
    bench configuration (small CPU runs)."""
    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch
    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models import heads, rpn
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        cast_params,
        forward_backbone_rpn,
        init_params,
        map_params,
        set_float32_precision,
    )
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
        anchor_targets,
        proposal_targets,
    )
    from mask_rcnn_tpu_torch.models.train_model import train_loss
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params
    from mask_rcnn_tpu_torch.utils.profiling import time_train_steps_chained

    set_float32_precision()  # float32 as the step runs it: no TF32
    line, peaks = common.card(device)
    cfg = common.bench_config(dtype, layers, **overrides)
    p_cfg = proposal_cfg or ProposalTargetConfig()
    a_cfg = AnchorTargetConfig()
    seed = 0
    kind = "bf16" if dtype == "bfloat16" else "f32"

    if batch is None:
        batch = make_synthetic_train_batch(batch_size, 832, 1344,
                                           np.random.RandomState(0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    n, h, w = batch["image"].shape[:3]
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    optimizer, _ = make_optimizer(params, 0.02, 1000)
    state = create_train_state(params, optimizer)
    cparams = cast_params(map_params(lambda t: t.detach(), params), dtype)
    flat = flatten_params(params)
    trainable = sorted(optimizer.trainable)
    img_size = (h, w)

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    def no_grad(fn):
        def wrapped(x):
            with torch.no_grad():
                return fn(x)
        return wrapped

    # ---- stage inputs, once ----
    def fwd_bb(img):
        return forward_backbone_rpn(cparams, cfg, img, train=True)

    with torch.no_grad():
        feats, rpn_locs, rpn_scores, anchors = fwd_bb(batch["image"])

    def do_propose(locs):
        return rpn.propose_batch(locs.float(), rpn_scores.float(), anchors,
                                 img_size, batch["scale"], cfg.proposal,
                                 train=True)

    rois, rois_valid = do_propose(rpn_locs)
    mask_packed = batch["mask"].shape[-1] * 8 == w

    def do_ptargets(r):
        return proposal_targets(
            r, rois_valid, batch["bbox"], batch["label"],
            batch["bbox_valid"], batch["mask"], p_cfg,
            cfg.loc_normalize_mean, cfg.loc_normalize_std,
            mask_packed=mask_packed, generator=gen())

    sample_rois = do_ptargets(rois)[0]

    def do_atargets(b):
        return anchor_targets(b, batch["bbox_valid"], anchors, img_size,
                              a_cfg, generator=gen())

    s = p_cfg.n_sample
    q = min(int(round(s * p_cfg.pos_ratio)), s)
    mask_subset = (torch.arange(n, device=device)[:, None] * s
                   + torch.arange(q, device=device)[None, :]).reshape(-1)

    def head(hp, f):
        return heads.head_forward(
            hp, f, sample_rois, roi_size=cfg.roi_size,
            spatial_scale=1.0 / cfg.feat_stride, pred_bbox=True,
            pred_mask=True, pooling=cfg.pooling,
            sampling_ratio=cfg.sampling_ratio, mask_subset=mask_subset)

    def do_head(f):
        return head(cparams["head"], f)

    def loss_of(img):
        return train_loss(params, cfg, {**batch, "image": img}, gen(),
                          anchor_cfg=a_cfg, proposal_cfg=p_cfg)[0]

    def do_grad(img):
        loss = loss_of(img)
        grads = torch.autograd.grad(loss, [flat[k] for k in trainable])
        return loss.detach() + common.grad_sum(grads)

    def grads_of(val, prefixes, extra=()):
        leaves = [flat[k] for k in trainable if k.startswith(prefixes)]
        grads = torch.autograd.grad(val, leaves + list(extra),
                                    allow_unused=True)
        return val.detach() + common.grad_sum(grads)

    def do_backbone_grad(img):
        # grads of the float32 master params with the cast inside, as in
        # train_loss
        cp = cast_params(params, dtype)
        f, locs, scores, _ = forward_backbone_rpn(cp, cfg, img, train=True)
        val = f.float().sum() + locs.float().sum() + scores.float().sum()
        return grads_of(val, ("extractor/", "rpn/"))

    def do_head_grad(f):
        f = f.detach().requires_grad_(True)
        out = head(cast_params(params, dtype)["head"], f)
        val = sum(v.float().sum() for v in out.values())
        return grads_of(val, ("head/",), (f,))

    step_fn = make_train_step(cfg, optimizer, proposal_cfg=p_cfg,
                              anchor_cfg=a_cfg)

    def one_step(_):
        new, metrics = step_fn(state, batch, seed)
        state.step = new.step
        return metrics["loss"]

    print(f"R-{layers}-C4 train profile @ {h}x{w} b{n} {dtype}; {line}")
    print(common.CONVENTIONS)
    print(f"MFU against the bf16 peak; roofline floors at the {kind} peak")
    print(f"{'stage':34s} {'device ms':>10s} {'events ms':>10s} "
          f"{'GFLOP':>9s} {'TFLOP/s':>8s} {'MFU':>6s} {'GB':>8s} "
          f"{'roofline floor':>19s} {'ach.':>6s}")
    rows = []

    def stage(name, build, feed, chained=None):
        row = common.measure(name, build, feed, reps, iters, chained)
        tf, mfu, floor, bound = common.rates(row, peaks, kind)
        print(f"{name:34s} {row['device_ms']:10.3f} {row['events_ms']:10.3f}"
              f" {row['flops'] / 1e9:9.1f} {tf:8.1f} {mfu:6.1%} "
              f"{row['bytes'] / 1e9:8.2f} floor={floor:8.3f}ms[{bound}] "
              f"{floor / row['device_ms']:6.1%}", flush=True)
        rows.append(row)

    stage("backbone+rpn fwd", no_grad(fwd_bb), batch["image"])
    stage(f"propose: NMS {cfg.proposal.n_train_pre_nms}->"
          f"{cfg.proposal.n_train_post_nms} x{n}", no_grad(do_propose),
          rpn_locs)
    stage("targets: proposal", no_grad(do_ptargets), rois)
    stage("targets: anchor", no_grad(do_atargets), batch["bbox"])
    stage("head fwd (align+res5+branches)", no_grad(do_head), feats)
    stage("backbone fwd+bwd", do_backbone_grad, batch["image"])
    stage("head fwd+bwd", do_head_grad, feats)
    stage("fwd loss (total)", no_grad(loss_of), batch["image"])
    stage("fwd+bwd (autograd.grad)", do_grad, batch["image"])
    stage("full step (chained steps)", one_step, batch["image"],
          lambda: time_train_steps_chained(step_fn, state, batch, seed,
                                           reps=reps, iters=iters))

    ms = [row["device_ms"] for row in rows]
    full_ms = ms[-1]
    parts_ms = ms[5] + ms[1] + ms[2] + ms[3] + ms[6]
    print(f"\nderived: bwd-only ~= {ms[8] - ms[7]:.3f} ms, "
          f"optimizer+state ~= {full_ms - ms[8]:.3f} ms, "
          f"non-backbone fwd overhead ~= {ms[7] - ms[0] - ms[4]:.3f} ms")
    print(f"unfused parts of the step (backbone fwd+bwd, propose, both "
          f"targets, head fwd+bwd) {parts_ms:.3f} ms of the full step's "
          f"{full_ms:.3f} ms; losses, casts and optimizer "
          f"{full_ms - parts_ms:.3f} ms")
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--layers", type=int, default=50, choices=(50, 101))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.batch, args.dtype, args.iters, args.reps, args.layers,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
