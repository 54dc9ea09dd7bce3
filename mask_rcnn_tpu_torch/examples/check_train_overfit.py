"""Does training optimize? The port of ``examples/check_train_overfit.py``
(the reference's tests/models_tests/check_mask_rcnn_train_chain.py flow):
400 steps of the whole train path (proposals, on-device targets, the 5
losses, momentum SGD) on two fixed synthetic images from scratch, at the
JAX script's configuration (2 classes, 256x320, anchor scales (2, 4, 8),
2000 -> 256 train proposals, 64 sampled anchors and rois, LR 2e-3, clip
norm 10, float32); then the detections on training image 0 at score
threshold 0.3. The JAX script's docstring records the loss falling from
~2.6 to below 1.8.

    python -m mask_rcnn_tpu_torch.examples.check_train_overfit \\
        [--steps 400] [--device cuda]

From-scratch notes: the frozen-affine recipe is tuned for pretrained
weights (the reference always starts from ImageNet); from scratch use
clip_norm and expect slow early progress.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

SPECS = (  # (y1, x1, y2, x2, class) of each image's two rectangles
    ((40, 50, 140, 160, 0), (160, 180, 230, 290, 1)),
    ((30, 200, 120, 300, 1), (150, 40, 240, 140, 0)),
)


def overfit_batch(mean):
    """The JAX script's two 256x320 images (noise around 60, rectangles of
    value 140 + 80 * class) with their boxes and masks, numpy."""
    rng = np.random.RandomState(0)
    h, w, g = 256, 320, 4
    imgs = rng.randn(2, h, w, 3).astype(np.float32) * 5 + 60
    boxes = np.zeros((2, g, 4), np.float32)
    labels = np.zeros((2, g), np.int32)
    valid = np.zeros((2, g), bool)
    masks = np.zeros((2, g, h, w), np.uint8)
    for i, sp in enumerate(SPECS):
        for j, (y1, x1, y2, x2, c) in enumerate(sp):
            imgs[i, y1:y2, x1:x2] = 140 + 80 * c
            boxes[i, j] = (y1, x1, y2, x2)
            labels[i, j] = c
            valid[i, j] = True
            masks[i, j, y1:y2, x1:x2] = 1
    batch = {
        "image": imgs - np.asarray(mean, np.float32),
        "bbox": boxes,
        "label": labels,
        "bbox_valid": valid,
        "mask": masks,
        "scale": np.ones((2,), np.float32),
    }
    return imgs, batch


def run_overfit(steps: int = 400, device="cuda", log_every: int = 50):
    """Train ``steps`` steps on ``device``; returns ``{"losses": [(step,
    metrics)] every ``log_every`` steps and at the last, "first", "last",
    "seconds", "detections": (bboxes, labels, scores) on image 0}``."""
    import torch

    from mask_rcnn_tpu_torch.engine.loop import upload_batch
    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        init_params,
    )
    from mask_rcnn_tpu_torch.models.rpn import ProposalConfig
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
    )

    device = torch.device(device)
    cfg = MaskRCNNConfig(
        n_fg_class=2, min_size=256, max_size=320,
        anchor_scales=(2.0, 4.0, 8.0),
        proposal=ProposalConfig(
            n_train_pre_nms=2000, n_train_post_nms=256,
            n_test_pre_nms=1000, n_test_post_nms=100,
        ),
        detections_per_im=10,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    optimizer, _ = make_optimizer(
        params, base_lr=2e-3, total_steps=100000, clip_norm=10.0
    )
    state = create_train_state(params, optimizer)
    step = make_train_step(
        cfg, optimizer,
        proposal_cfg=ProposalTargetConfig(n_sample=64),
        anchor_cfg=AnchorTargetConfig(n_sample=64),
    )
    imgs, batch = overfit_batch(cfg.mean)
    batch = upload_batch(batch, device)

    t0 = time.perf_counter()
    losses = []
    for it in range(steps):
        # the step's sampling generator is seeded from (7, step)
        state, metrics = step(state, batch, 7)
        if it % log_every == 0 or it == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            losses.append((it, m))
            print(
                f"it {it:4d} loss {m['loss']:.3f} "
                f"rpn_cls {m['rpn_cls_loss']:.3f} "
                f"roi_cls {m['roi_cls_loss']:.3f} "
                f"mask {m['roi_mask_loss']:.3f}", flush=True
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    first, last = losses[0][1]["loss"], losses[-1][1]["loss"]
    print(f"{steps} steps in {seconds:.1f}s; loss {first:.2f} -> "
          f"{last:.2f}")

    model = MaskRCNNResNet.from_config(cfg, state.params, device=device)
    model.score_thresh = 0.3
    bb, _, lb, sc = model.predict([imgs[0].transpose(2, 0, 1)])
    print(f"detections on train image: {len(bb[0])}")
    for b, l, s in zip(bb[0], lb[0], sc[0]):
        print(f"  label {int(l)} score {s:.2f} box {np.round(b, 1)}")
    return {"losses": losses, "first": first, "last": last,
            "seconds": seconds, "detections": (bb[0], lb[0], sc[0])}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to train on ('cpu' runs every kernel's plain "
        "version)",
    )
    args = parser.parse_args(argv)
    out = run_overfit(args.steps, args.device)
    assert np.isfinite(out["last"]) and out["last"] < out["first"], \
        "training did not optimize"
    print("OK")
    return out


if __name__ == "__main__":
    main()
