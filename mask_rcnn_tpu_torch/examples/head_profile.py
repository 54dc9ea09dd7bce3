"""Micro-attribution of the RoI head's forward and backward, the port of
``examples/head_profile.py`` (companion to ``train_profile``).

Times each head component alone, forward and forward+backward (the
gradient in the component's input, as the JAX script's
``value_and_grad``): RoIAlign on flat rois (K4/K13) and grouped rois
(K1/K7), res5, the mask branch on a quarter of the rois, the avgpool +
linears tail, and the whole ``models/heads.py::head_forward`` with
``mask_subset``.

    python -m mask_rcnn_tpu_torch.examples.head_profile \\
        [--rois 1024] [--batch 2] [--dtype bfloat16]

Columns: device ms (the union of device activity of a chained run), CUDA-
event ms of back-to-back calls (host-paced), GFLOP, TFLOP/s on device
time, MFU against the card's bf16 peak, GB. Entry points run on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mask_rcnn_tpu_torch.examples import _profile_common as common


def run(rois=1024, batch=2, dtype="bfloat16", iters=6, reps=10,
        device="cuda", height=832, width=1344):
    """Prints the table; returns the rows."""
    from mask_rcnn_tpu_torch.models import heads
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        cast_params,
        init_params,
        set_float32_precision,
    )
    from mask_rcnn_tpu_torch.models.resnet import conv2d, res5_forward
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    set_float32_precision()  # float32 as the step runs it: no TF32
    line, peaks = common.card(device)
    h, w = height // 16, width // 16  # C4 feature grid
    n, r = batch, rois
    cfg = common.bench_config(dtype)
    dt = getattr(torch, dtype)

    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(n, h, w, 1024).astype(
        np.float32)).to(device).to(dt)
    # realistic roi mix: uniform boxes over the image
    y1 = rng.uniform(0, 700 * height / 832, r)
    x1 = rng.uniform(0, 1200 * width / 1344, r)
    rois_f = np.stack([y1, x1, y1 + rng.uniform(30, 130, r),
                       x1 + rng.uniform(30, 130, r)], 1).astype(np.float32)
    ridx = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int32),
                                      r // n)).to(device)
    rois_g = torch.from_numpy(rois_f.reshape(n, r // n, 4)).to(device)
    rois_f = torch.from_numpy(rois_f).to(device)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    hp = cast_params(params, dtype)["head"]
    with torch.no_grad():
        pooled = ra.roi_align_grouped(feats, rois_g, 7, 1.0 / 16, 0,
                                      2).reshape(-1, 7, 7, 1024)
        res5_out = res5_forward(hp["res5"], pooled, stride=1)
    q = r // 4
    mask_in = res5_out[:q].contiguous()

    print(f"head micro-profile: {r} rois, b{n} feats {h}x{w} {dtype}; "
          f"{line}")
    print(common.CONVENTIONS)
    print(f"{'component':38s} {'device ms':>10s} {'events ms':>10s} "
          f"{'GFLOP':>9s} {'TFLOP/s':>8s} {'MFU':>6s} {'GB':>8s}")
    rows = []

    def row(name, build, feed):
        got = common.measure(name, build, feed, reps, iters)
        tf, mfu = common.rates(got, peaks)[:2]
        print(f"{name:38s} {got['device_ms']:10.3f} {got['events_ms']:10.3f}"
              f" {got['flops'] / 1e9:9.1f} {tf:8.1f} {mfu:6.1%} "
              f"{got['bytes'] / 1e9:8.2f}", flush=True)
        rows.append(got)

    def al(f):
        return ra.roi_align(f, rois_f, ridx, 7, 1.0 / 16, 0, 2)

    def alg(f):
        return ra.roi_align_grouped(f, rois_g, 7, 1.0 / 16, 0, 2)

    def r5(x):
        return res5_forward(hp["res5"], x, stride=1)

    def mask_branch(x):
        d = torch.relu(heads.deconv2x2_s2(x, hp["deconv6"]["W"],
                                          hp["deconv6"]["b"]))
        return conv2d(d, hp["mask"]["W"]) + hp["mask"]["b"]

    def tail(x):
        p5 = x.mean(dim=(1, 2))
        return ((p5 @ hp["cls_loc"]["W"] + hp["cls_loc"]["b"]).float().sum()
                + (p5 @ hp["score"]["W"] + hp["score"]["b"]).float().sum())

    subset = torch.arange(q, device=device)

    def full(f):
        out = heads.head_forward(
            hp, f, rois_g, roi_size=14, spatial_scale=1.0 / 16,
            pred_bbox=True, pred_mask=True, sampling_ratio=0,
            mask_subset=subset)
        return sum(v.float().sum() for v in out.values())

    row("align flat fwd", al, feats)
    row("align flat fwd+bwd", common.fwd_bwd(al), feats)
    row("align grouped fwd", alg, feats)
    row("align grouped fwd+bwd", common.fwd_bwd(alg), feats)
    row("res5 fwd", r5, pooled)
    row("res5 fwd+bwd", common.fwd_bwd(r5), pooled)
    row(f"mask branch fwd ({q} rois)", mask_branch, mask_in)
    row(f"mask branch fwd+bwd ({q} rois)", common.fwd_bwd(mask_branch),
        mask_in)
    row("avgpool+linears fwd", tail, res5_out)
    row("avgpool+linears fwd+bwd", common.fwd_bwd(tail), res5_out)
    row("full head fwd", full, feats)
    row("full head fwd+bwd", common.fwd_bwd(full), feats)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rois", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.rois, args.batch, args.dtype, args.iters, args.reps,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
