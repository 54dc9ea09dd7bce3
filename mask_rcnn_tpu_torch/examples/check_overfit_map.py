"""Does the whole train -> predict -> evaluate pipeline produce mAP? The
port of ``examples/check_overfit_map.py``: the real CLI configuration
(``train_common.train``: loader, transform, on-device targets, losses, SGD
schedule, VOC 07-metric AP, the visualization report) on 20 synthetic
VOC-like images (1-3 non-overlapping textured instances of 3 classes),
trained from scratch until validation mAP@50 saturates, gated at 0.9.

    python -m mask_rcnn_tpu_torch.examples.check_overfit_map \\
        [--max-epoch 600] [--device cuda]

The JAX script's defaults: 600 epochs at batch 2 (6000 steps, the LR
decays at 4000 and 5333), LR 2e-3, clip norm 10, float32, uint8 input,
min 320 / max 448, anchor scales (2, 4, 8, 16), an evaluation every 50
epochs. Prints the mAP@50 at each evaluation, the wall seconds and ms a
step; exits 1 below the gate.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

import numpy as np

CLASS_NAMES = ("box", "disk", "stripe")


def make_synthetic_voc_like(n=20, h=320, w=400, seed=0):
    """Deterministic images with 1-3 strongly-textured instances each."""
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(n):
        img = (rng.randn(h, w, 3) * 10 + 90).clip(0, 255).astype(np.uint8)
        k = rng.randint(1, 4)
        bboxes, labels, masks = [], [], []
        placed = []
        for _ in range(k):
            cls = rng.randint(0, len(CLASS_NAMES))
            bh = rng.randint(60, 140)
            bw = rng.randint(60, 140)
            # Non-overlapping placement: an occluded instance's recorded
            # mask would otherwise claim pixels the image shows as the
            # occluder's, putting a hard ceiling on achievable mask IoU.
            y1 = x1 = None
            for _attempt in range(20):
                ty = rng.randint(0, h - bh)
                tx = rng.randint(0, w - bw)
                if all(
                    ty + bh <= py1 or ty >= py2 or tx + bw <= px1
                    or tx >= px2
                    for py1, px1, py2, px2 in placed
                ):
                    y1, x1 = ty, tx
                    break
            if y1 is None:
                continue
            placed.append((y1, x1, y1 + bh, x1 + bw))
            mask = np.zeros((h, w), np.int32)
            if cls == 0:  # solid bright box
                mask[y1:y1 + bh, x1:x1 + bw] = 1
                img[mask > 0] = (230, 60, 60)
            elif cls == 1:  # disk
                yy, xx = np.mgrid[:h, :w]
                cy, cx = y1 + bh / 2, x1 + bw / 2
                mask[((yy - cy) / (bh / 2)) ** 2
                     + ((xx - cx) / (bw / 2)) ** 2 <= 1.0] = 1
                img[mask > 0] = (60, 220, 60)
            else:  # horizontally striped box
                mask[y1:y1 + bh, x1:x1 + bw] = 1
                img[mask > 0] = (60, 60, 230)
                stripe = (np.arange(h)[:, None] // 8 % 2 == 0)
                img[(mask > 0) & np.broadcast_to(stripe, (h, w))] = (
                    240, 240, 80
                )
            ys, xs = np.nonzero(mask)
            bboxes.append([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
            labels.append(cls)
            masks.append(mask)
        examples.append(
            (
                img,
                np.asarray(bboxes, np.float32),
                np.asarray(labels, np.int32),
                np.asarray(masks, np.int32),
            )
        )

    class DS:
        class_names = CLASS_NAMES

        def __len__(self):
            return len(examples)

        def __getitem__(self, i):
            return examples[i]

    return DS()


def run_overfit_map(max_epoch=600.0, lr=2e-3, batch_size_per_gpu=2,
                    eval_interval_epochs=50.0, logs_dir="logs/overfit_map",
                    init_from=None, device="cuda", n_images=20):
    """Train and evaluate on ``n_images`` of the generator's images (train
    and test set alike) on ``device``; returns ``train_common.train``'s
    result with ``"trajectory"``: [(iteration, mAP@50)] of each
    evaluation."""
    from mask_rcnn_tpu_torch.examples import train_common

    ds = make_synthetic_voc_like(n=n_images)
    # the drivers' flags at their defaults (resnet50, align, roi 14, normal
    # init, seed 0, one process), then the check's own
    args = train_common.parse_args({}, [])
    args.pretrained_model = init_from
    args.max_epoch = max_epoch
    args.batch_size_per_gpu = batch_size_per_gpu
    args.lr = lr
    args.max_boxes = 8
    args.logs_dir = logs_dir
    args.eval_interval_epochs = eval_interval_epochs
    args.compute_dtype = "float32"
    args.clip_norm = 10.0  # from-scratch training (no pretrained stats)
    args.input_uint8 = True
    args.device = device
    # A smaller resolution than the COCO/VOC recipes so the check finishes
    # in minutes on one card; the CLI machinery exercised is identical (the
    # per-dataset min/max/anchors are parameters, as in custom_dataset).
    result = train_common.train(
        args, ds, ds, CLASS_NAMES, "voc",
        min_size=320, max_size=448, anchor_scales=(2, 4, 8, 16),
    )
    with open(osp.join(result["log_dir"], "log")) as f:
        result["trajectory"] = [
            (e["iteration"], e["validation/main/map"]) for e in json.load(f)
            if "validation/main/map" in e]
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--max-epoch", type=float, default=600.0)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--batch-size-per-gpu", type=int, default=2)
    parser.add_argument("--eval-interval-epochs", type=float, default=50.0)
    parser.add_argument("--logs-dir", default="logs/overfit_map")
    parser.add_argument(
        "--init-from", default=None,
        help="warm-start from a snapshot_model.npz (continue refining)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to train on ('cpu' runs every kernel's plain "
        "version)",
    )
    a = parser.parse_args(argv)
    result = run_overfit_map(a.max_epoch, a.lr, a.batch_size_per_gpu,
                             a.eval_interval_epochs, a.logs_dir,
                             a.init_from, a.device)
    print("trajectory (iteration, mAP@50): " + ", ".join(
        f"({i}, {m:.4f})" for i, m in result["trajectory"]))
    print(f"OVERFIT_BENCH map@0.5 = {result['best_map']:.4f} "
          f"({result['iterations']} iterations, {result['elapsed']:.1f}s, "
          f"{result['elapsed'] * 1e3 / result['iterations']:.2f} ms/step "
          "with the evaluations)")
    if result["best_map"] < 0.9:
        print("WARNING: below the 0.9 overfit gate")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
