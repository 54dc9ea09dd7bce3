"""Shared evaluation CLI, the port of ``examples/evaluate_common.py`` (the
reference's examples/evaluate_common.py): rebuild the model from a log
dir's ``params.yaml`` and snapshot (``log_dir.py``), evaluate over the
test set, write ``snapshot_model.npz.eval_result.yaml`` (as JSON, which
is valid YAML); before that, draw the examples ``indices_vis`` into
``<log dir>/visualizations/`` (``VisReport`` at score threshold 0.7, which
needs cv2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp


def evaluate(test_data, class_names, dataset_kind, indices_vis=None,
             use_07_metric=False, argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--max-examples", type=int, default=None)
    parser.add_argument(
        "--strict-parity", action="store_true",
        help="bit-closest reference decode: per-class NMS considers every "
        "box above score 0.05 (nms_topk_per_class=0) and compute runs in "
        "float32",
    )
    parser.add_argument(
        "--pool-detections", action="store_true",
        help="multi-process eval: gather every rank's compact match records "
        "and score them together (the exact global mAP) instead of "
        "averaging the ranks' reports; one process: no effect",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to evaluate on ('cpu' runs every kernel's plain "
        "version)",
    )
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.data import IndexingDataset
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
        VisReport,
    )
    from mask_rcnn_tpu_torch.examples.log_dir import (
        build_model_from_log_dir,
    )

    model, _ = build_model_from_log_dir(args.log_dir, device=args.device)
    # pad_to_bucket defaults True, so the dataset sweep runs at most two
    # padded shapes (one per orientation bucket).
    if args.strict_parity:
        model.config = dataclasses.replace(
            model.config, nms_topk_per_class=0, compute_dtype="float32"
        )
        # bucket padding is the one documented deliberate decode deviation
        # (mean-level padding is only float-tolerance-equal to tight
        # padding) — strict mode removes it too.
        model.pad_to_bucket = False
    if indices_vis:
        indices_vis = [i for i in indices_vis if i < len(test_data)]
    if indices_vis:
        vis = VisReport(
            IndexingDataset(test_data, indices_vis), class_names,
            args.log_dir, indices=range(len(indices_vis)),
        )
        model.score_thresh = vis.score_thresh
        vis(model)
        model.score_thresh = 0.05

    evaluator = InstanceSegmentationEvaluator(
        test_data, class_names, kind=dataset_kind,
        batch_size=args.batch_size, use_07_metric=use_07_metric,
        max_examples=args.max_examples,
        pool_detections=args.pool_detections,
    )
    report = evaluator(model)
    out = osp.join(args.log_dir, "snapshot_model.npz.eval_result.yaml")
    with open(out, "w") as f:
        json.dump({k: float(v) for k, v in report.items()}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    for k, v in sorted(report.items()):
        print(f"{k}: {v:.4f}")
    print(f"-> {out}")
    return report
