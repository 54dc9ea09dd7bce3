"""Instance-mask / box geometry utilities (host-side numpy), a copy of
``mask_rcnn_tpu/utils/geometry.py`` (importing that package would import
jax).

Capability parity with reference utils/geometry.py:7-218: conversions between
(class-label image, instance-label image) pairs and per-instance
(label, bbox, mask) tuples, plus mask/box overlap helpers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_bbox_overlap(bbox1, bbox2) -> float:
    """IoU of two (y1, x1, y2, x2) boxes."""
    y1 = max(bbox1[0], bbox2[0])
    x1 = max(bbox1[1], bbox2[1])
    y2 = min(bbox1[2], bbox2[2])
    x2 = min(bbox1[3], bbox2[3])
    ih = max(y2 - y1, 0.0)
    iw = max(x2 - x1, 0.0)
    inter = ih * iw
    a1 = (bbox1[2] - bbox1[0]) * (bbox1[3] - bbox1[1])
    a2 = (bbox2[2] - bbox2[0]) * (bbox2[3] - bbox2[1])
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0


def get_mask_overlap(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """IoU of two binary masks."""
    inter = np.logical_and(mask1, mask2).sum()
    union = np.logical_or(mask1, mask2).sum()
    return float(inter / union) if union > 0 else 0.0


def mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    """Binary mask -> (y1, x1, y2, x2) float32 tight box (exclusive ends)."""
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return np.zeros((4,), np.float32)
    return np.asarray(
        [ys.min(), xs.min(), ys.max() + 1, xs.max() + 1], np.float32
    )


def masks_to_bboxes(masks: np.ndarray) -> np.ndarray:
    return np.asarray([mask_to_bbox(m) for m in masks], np.float32).reshape(
        -1, 4
    )


def label2instance_boxes(
    label_instance: np.ndarray,
    label_class: np.ndarray,
    return_masks: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(instance-id image, class-label image) -> per-instance arrays.

    Instance ids <= 0 are background; the class of each instance is the
    pixel-majority class over its support (reference geometry.py:112-113).

    Returns (labels (R,), bboxes (R, 4), masks (R, H, W) bool).
    """
    instances = np.unique(label_instance)
    instances = instances[instances > 0]
    labels, bboxes, masks = [], [], []
    for inst in instances:
        mask = label_instance == inst
        cls, cnt = np.unique(label_class[mask], return_counts=True)
        keep = cls > 0
        cls, cnt = cls[keep], cnt[keep]
        if len(cls) == 0:
            continue
        labels.append(int(cls[cnt.argmax()]))
        bboxes.append(mask_to_bbox(mask))
        masks.append(mask)
    labels = np.asarray(labels, np.int32)
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
    masks = np.asarray(masks, bool).reshape(
        (-1,) + label_instance.shape
    )
    if return_masks:
        return labels, bboxes, masks
    return labels, bboxes


def instance_boxes2label(
    labels: np.ndarray,
    bboxes: np.ndarray,
    masks: np.ndarray,
    scores: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of label2instance_boxes: paint instances (ascending score so
    higher-scored instances end up on top)."""
    if len(masks) == 0:
        raise ValueError("needs at least one instance")
    h, w = masks.shape[1:]
    label_class = np.zeros((h, w), np.int32)
    label_instance = np.zeros((h, w), np.int32)
    order = (
        np.argsort(scores) if scores is not None else np.arange(len(labels))
    )
    for rank, i in enumerate(order):
        label_class[masks[i]] = labels[i]
        label_instance[masks[i]] = rank + 1
    return label_class, label_instance


def label_rois(rois, label_instance, label_class, overlap_thresh=0.5):
    """Assign instance classes/masks to rois by best box overlap
    (reference geometry.py:183-218): class 0 + None mask below threshold.

    Returns (roi_classes (R,) int32, list of per-roi cropped masks or None).
    """
    inst_clss, inst_rois, inst_masks = label2instance_boxes(
        label_instance, label_class
    )
    roi_clss, roi_inst_masks = [], []
    for roi in rois:
        overlaps = [get_bbox_overlap(roi, ir) for ir in inst_rois]
        ind = int(np.argmax(overlaps)) if overlaps else 0
        if overlaps and overlaps[ind] > overlap_thresh:
            y1, x1, y2, x2 = [int(v) for v in roi]
            roi_clss.append(int(inst_clss[ind]))
            roi_inst_masks.append(inst_masks[ind][y1:y2, x1:x2])
        else:
            roi_clss.append(0)
            roi_inst_masks.append(None)
    return np.asarray(roi_clss, np.int32), roi_inst_masks


def label_to_bboxes(label: np.ndarray, ignore_label=(-1, 0)) -> np.ndarray:
    """Boxes for each unique region id in a label image."""
    ids = np.unique(label)
    ids = ids[~np.isin(ids, ignore_label)]
    return np.asarray(
        [mask_to_bbox(label == i) for i in ids], np.float32
    ).reshape(-1, 4)
