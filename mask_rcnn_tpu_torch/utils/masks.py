"""Mask pasting (Detectron ``segm_results`` parity) and the bilinear
resize it and image preparation share, the port of
``mask_rcnn_tpu/utils/masks.py`` without cv2.

The 14x14 roi mask is zero-padded to 16x16, the box expanded by (M+2)/M,
resized to the integer box size, thresholded at 0.5 and pasted into the
full-image mask with clipping.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_taps(in_size: int, out_size: int, inv_scale: float, device):
    """cv2 ``INTER_LINEAR`` taps along one axis: source coordinate
    ``(d + .5) * inv_scale - .5`` (computed in double, used in float),
    clamped at 0, edge-replicated at ``in_size - 1``."""
    d = torch.arange(out_size, dtype=torch.float64, device=device)
    src = ((d + 0.5) * inv_scale - 0.5).to(torch.float32)
    low = torch.floor(src)
    frac = src - low
    low = low.to(torch.int64)
    frac = torch.where(low < 0, 0.0, frac)
    low = torch.clamp(low, min=0)
    at_edge = low >= in_size - 1
    frac = torch.where(at_edge, 0.0, frac)
    low = torch.where(at_edge, in_size - 1, low)
    high = torch.where(at_edge, low, low + 1)
    return low, high, frac


def resize_bilinear(img, out_h: int, out_w: int, scale_y=None, scale_x=None):
    """Bilinear resize of an (H, W, ...) tensor with cv2 ``INTER_LINEAR``
    semantics (half-pixel centres, no antialias), float32 result.

    ``scale_y``/``scale_x`` are cv2's ``fy``/``fx`` when the caller passed
    scale factors (the sampling grid then follows the factor, not the
    rounded output size); by default they are ``out / in``.
    """
    h, w = img.shape[:2]
    inv_y = 1.0 / scale_y if scale_y else h / out_h
    inv_x = 1.0 / scale_x if scale_x else w / out_w
    x = img.to(torch.float32)
    # horizontal pass first, then vertical, like cv2
    lo, hi, f = _axis_taps(w, out_w, inv_x, img.device)
    f = f.reshape((1, -1) + (1,) * (x.dim() - 2))
    x = x[:, lo] * (1.0 - f) + x[:, hi] * f
    lo, hi, f = _axis_taps(h, out_h, inv_y, img.device)
    f = f.reshape((-1,) + (1,) * (x.dim() - 1))
    return x[lo] * (1.0 - f) + x[hi] * f


def expand_boxes(boxes: np.ndarray, scale: float) -> np.ndarray:
    """Scale (x1, y1, x2, y2) boxes about their centers."""
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    out = np.zeros(boxes.shape)
    out[:, 0] = x_c - w_half
    out[:, 2] = x_c + w_half
    out[:, 1] = y_c - h_half
    out[:, 3] = y_c + h_half
    return out


def boxlocal_masks(bbox, mask_probs, im_h: int, im_w: int):
    """Per-detection clipped box-local binarized masks: exactly the pixels
    :func:`paste_masks` writes. ``bbox`` (R, 4) numpy, ``mask_probs``
    (R, M, M) numpy.

    Returns a list of ``(local (h_i, w_i) bool, y0, x0)``; an empty local
    (shape (0, 0)) marks a detection fully outside the image.
    """
    r = len(bbox)
    empty = np.zeros((0, 0), dtype=bool)
    if r == 0:
        return []
    m = mask_probs.shape[1]
    ref_boxes = bbox[:, [1, 0, 3, 2]]  # -> x1, y1, x2, y2
    ref_boxes = expand_boxes(ref_boxes, (m + 2.0) / m)
    ref_boxes = ref_boxes.astype(np.int32)
    padded = torch.zeros((m + 2, m + 2), dtype=torch.float32)

    out = []
    for i in range(r):
        padded[1:-1, 1:-1] = torch.from_numpy(
            np.asarray(mask_probs[i], np.float32))
        ref = ref_boxes[i]
        w = max(ref[2] - ref[0] + 1, 1)
        h = max(ref[3] - ref[1] + 1, 1)
        binarized = (resize_bilinear(padded, int(h), int(w)) > 0.5).numpy()

        x_0 = max(ref[0], 0)
        x_1 = min(ref[2] + 1, im_w)
        y_0 = max(ref[1], 0)
        y_1 = min(ref[3] + 1, im_h)
        if x_1 <= x_0 or y_1 <= y_0:
            out.append((empty, 0, 0))
            continue
        out.append((
            binarized[
                (y_0 - ref[1]):(y_1 - ref[1]), (x_0 - ref[0]):(x_1 - ref[0])
            ],
            y_0,
            x_0,
        ))
    return out


def paste_masks(bbox: np.ndarray, mask_probs: np.ndarray, im_h: int,
                im_w: int) -> np.ndarray:
    """(R, M, M) mask probabilities -> (R, im_h, im_w) bool full-image
    masks; ``bbox`` (R, 4) (y1, x1, y2, x2) in image coords."""
    r = len(bbox)
    out = np.zeros((r, im_h, im_w), dtype=bool)
    for i, (local, y0, x0) in enumerate(
        boxlocal_masks(bbox, mask_probs, im_h, im_w)
    ):
        h, w = local.shape
        out[i, y0:y0 + h, x0:x0 + w] = local
    return out


def boxlocal_inter_areas(locals_, gt_masks, det_labels, gt_labels):
    """Det-vs-gt intersections + areas from box-local masks.

    The shared ingestion core of ``COCOEvaluation.add_boxlocal`` and
    ``VOCEvaluation.add_boxlocal`` (one implementation so the two metrics
    cannot diverge): intersections are integer counts over each detection's
    clipped box crop, computed for label-equal pairs only (cross-class
    entries stay 0 — the evaluators never read them). Dispatches to the C++
    kernel (``native.boxlocal_inter``) when available; the numpy path below
    is the fallback.

    Args:
        locals_: ``[(local (h, w) bool, y0, x0), ...]`` from
            :func:`boxlocal_masks` (already clipped to the image).
        gt_masks: (G, H, W) bool.
        det_labels, gt_labels: int labels.

    Returns:
        (inter (D, G) int64, det_area (D,) int64, gt_area (G,) int64).
    """
    from mask_rcnn_tpu_torch.utils import native

    dl = np.asarray(det_labels)
    gl = np.asarray(gt_labels)
    d, g = len(dl), len(gl)
    if d and g:
        res = native.boxlocal_inter(locals_, gt_masks, dl, gl)
        if res is not None:
            return res
    det_area = np.asarray(
        [local.sum() for local, _, _ in locals_], np.int64
    )
    gt_area = (
        gt_masks.sum(axis=(1, 2)).astype(np.int64)
        if g else np.zeros(0, np.int64)
    )
    inter = np.zeros((d, g), np.int64)
    if d and g:
        for lbl in np.unique(np.concatenate([dl, gl])):
            di = np.flatnonzero(dl == lbl)
            gi = np.flatnonzero(gl == lbl)
            if not len(di) or not len(gi):
                continue
            gmc = gt_masks[gi]  # hoisted: one copy per class, not per det
            for p in di:
                local, y0, x0 = locals_[p]
                h, w = local.shape
                if h and w:
                    crop = gmc[:, y0:y0 + h, x0:x0 + w]
                    inter[p, gi] = (crop & local[None]).sum(axis=(1, 2))
    return inter, det_area, gt_area
