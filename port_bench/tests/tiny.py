"""A tiny copy of the benchmark for CPU tests: the cells' traffic kinds on a
small R-50-C4 (4 classes, 128/192 images, few proposals), written into a
temporary root beside copies of the real files."""

from __future__ import annotations

import copy
import json
import os.path as osp
import shutil

HERE = osp.dirname(osp.dirname(osp.abspath(__file__)))
REPO = osp.dirname(HERE)

MODEL = {
    "n_layers": 50, "n_fg_class": 4, "min_size": 128, "max_size": 192,
    "ratios": [0.5, 1.0, 2.0], "anchor_scales": [2.0, 4.0, 8.0],
    "mean": [123.152, 115.903, 103.063], "feat_stride": 16,
    "rpn_hidden": 1024, "roi_size": 14, "mask_size": 14, "pooling": "align",
    "sampling_ratio": 0,
    "proposal": {"nms_thresh": 0.7, "n_train_pre_nms": 300,
                 "n_train_post_nms": 100, "n_test_pre_nms": 200,
                 "n_test_post_nms": 50, "min_size": 0.0},
    "loc_normalize_mean": [0.0, 0.0, 0.0, 0.0],
    "loc_normalize_std": [0.1, 0.1, 0.2, 0.2], "nms_thresh": 0.5,
    "score_thresh": 0.05, "detections_per_im": 10, "nms_topk_per_class": 20,
    "compute_dtype": "float32"}
TRAIN = {"lr": 0.005, "momentum": 0.9, "weight_decay": 0.0001,
         "total_steps": 360000, "rpn_sigma": 3.0, "roi_sigma": 1.0,
         "anchor_target": {"n_sample": 256, "pos_iou_thresh": 0.7,
                           "neg_iou_thresh": 0.3, "pos_ratio": 0.5},
         "proposal_target": {"n_sample": 64, "pos_ratio": 0.25,
                             "pos_iou_thresh": 0.5, "neg_iou_thresh_hi": 0.5,
                             "neg_iou_thresh_lo": 0.0, "mask_size": 14}}
WEIGHTS = {"seed": 20180101, "rpn": 0.01, "cls_loc": 0.001, "score": 2.0,
           "deconv6": 0.1, "mask": 2.0}
IMAGES = {"long": 160, "short_min": 90, "short_max": 150,
          "portrait_share": 0.34}
TRAFFIC = {
    "tiny-stream": {"mode": "stream", "batch": 2,
                    "pool_batches": 3, "images": IMAGES, "check_images": 2,
                    "trace_seconds": 1},
    "tiny-online": {"mode": "online", "batch": 1, "pool_batches": 4,
                    "rate": 2.0, "arrival_seed": 1, "images": IMAGES,
                    "check_images": 2,
                    "trace_seconds": 1},
    "tiny-train": {"mode": "train", "batch": 2, "pool_batches": 3,
                   "same_orientation": True, "images": IMAGES,
                   "instances": {"max_boxes": 8, "instances_mean": 3,
                                 "instances_sigma": 0.9,
                                 "area_shares": {"small": 0.41,
                                                 "medium": 0.34,
                                                 "large": 0.24},
                                 "side_px": {"small": [8, 32],
                                             "medium": [32, 96],
                                             "large": [96, 150]}},
                    "trace_seconds": 1},
}
CELLS = {"tiny.stream": "tiny-stream", "tiny.online": "tiny-online",
         "tiny.train": "tiny-train"}
# float32 on both sides: the plain path against the reference
LIMITS = {"tiny.stream": {"score_gap": 1e-3, "box_gap": 1e-3,
                          "mask_share": 1e-3, "miss_share": 0.0},
          "tiny.online": {"score_gap": 1e-3, "box_gap": 1e-3,
                          "mask_share": 1e-3, "miss_share": 0.0},
          "tiny.train": {"loss_gap": 1e-3, "grad_gap": 1e-3,
                         "update_gap": 1e-3, "grad_diff": 1e-3}}


def make_root(dst):
    """Copy ``BENCHMARK.json`` and ``port_bench`` to ``dst`` and add the
    tiny configuration, traffic, limits and cells as files of their own
    and entries; -> dst."""
    shutil.copy(osp.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(HERE, osp.join(dst, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = osp.join(dst, "port_bench")
    with open(osp.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump({"source": "test", "architecture": "c4", "model": MODEL,
                   "train": TRAIN, "weights": WEIGHTS}, f)
    for name, t in TRAFFIC.items():
        with open(osp.join(pb, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    for cell, lim in LIMITS.items():
        with open(osp.join(pb, "limits", cell + ".json"), "w") as f:
            json.dump(lim, f)
    with open(osp.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "port_bench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    for cell, traffic in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "tests"})
    mode = {c: TRAFFIC[t]["mode"] for c, t in CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            real_modes = {json.load(open(osp.join(
                pb, "traffic", next(w["traffic"] for w in bench["workloads"]
                                    if w["name"] == c) + ".json")))["mode"]
                for c in m["workloads"]}
            m["workloads"] += [c for c in CELLS if mode[c] in real_modes]
    with open(osp.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def config(**model):
    return {"architecture": "c4",
            "model": dict(copy.deepcopy(MODEL), **model),
            "train": copy.deepcopy(TRAIN), "weights": dict(WEIGHTS)}
