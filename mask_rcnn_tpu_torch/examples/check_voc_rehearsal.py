"""Synthetic-SBD dress rehearsal of the port's whole VOC driver surface,
the port of ``examples/check_voc_rehearsal.py``; the COCO twin is
``check_coco_rehearsal.py``, whose journey it runs.

Writes an on-disk SBD root (``data/synthetic.py``: img/*.jpg, GTcls/GTinst
.mat structs and SDS-layout split lists; JPEG needs cv2 or PIL, the .mat
files scipy), then runs

    SBD_ROOT=... python -m mask_rcnn_tpu_torch.examples.voc.train
    SBD_ROOT=... python -m mask_rcnn_tpu_torch.examples.voc.evaluate logs/<ts>
    python -m mask_rcnn_tpu_torch.examples.voc.demo logs/<ts> --images ...
    python -m mask_rcnn_tpu_torch.examples.summarize_logs logs/

and checks the same artifact contract, and unless ``--min-map -1`` a bar
on the VOC 07-metric mAP@50. The last line printed is a JSON summary.

On the card (the drivers' defaults: min 600 / max 1000):
    python -m mask_rcnn_tpu_torch.examples.check_voc_rehearsal \\
        --max-epoch 150
Tiny CPU run (same flow, small shapes):
    python -m mask_rcnn_tpu_torch.examples.check_voc_rehearsal \\
        --min-size 64 --max-size 96 --max-epoch 2 --min-map -1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import tempfile

from mask_rcnn_tpu_torch.examples.check_coco_rehearsal import (
    add_common_args,
    journey,
)


def main(argv=None):
    """Returns the summary (also printed as the last line)."""
    parser = argparse.ArgumentParser()
    add_common_args(parser, 150.0, "360 480", "600/1000 VOC")
    parser.add_argument("--min-map", type=float, default=0.5,
                        help="required validation/main/map (VOC 07-metric "
                        "AP@50) from the evaluate step (-1 disables the "
                        "bar for smoke runs)")
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_sbd_root

    workdir = args.workdir or tempfile.mkdtemp(prefix="voc_rehearsal_")
    os.makedirs(workdir, exist_ok=True)
    hw = args.image_hw or ((96, 128) if args.min_size else (360, 480))
    sbd_root = make_synthetic_sbd_root(
        osp.join(workdir, "SBD"), n_val=args.n_val,
        height=hw[0], width=hw[1], seed=args.seed,
    )
    with open(osp.join(sbd_root, "ImageSets/Main/val.txt")) as f:
        val_id = f.readline().strip()
    log_dir, entries, eval_result = journey(
        args, "voc", dict(os.environ, SBD_ROOT=sbd_root),
        osp.join(workdir, "logs"), osp.join(sbd_root, "img", val_id + ".jpg"),
        osp.join(workdir, "demo_out"), "validation/main/map")

    summary = {
        "check": "voc_rehearsal",
        "map": float(eval_result.get("validation/main/map", float("nan"))),
        "steps": int(entries[-1].get("iteration", 0)),
        "log_dir": log_dir,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
