"""VOC-style instance segmentation AP, the port of
``mask_rcnn_tpu/utils/voc_eval.py`` (reference
utils/evaluations/eval_instance_segmentation_voc.py:13-181 parity, without
chainercv).

Per-image matching follows chainercv's selec logic exactly: each score-sorted
prediction is assigned its argmax-IoU gt of the class (if IoU >= thresh); the
prediction counts as a TP only if that specific gt is not already selected,
otherwise as an FP. Difficult gts yield match=-1 (excluded from both TP and
FP). Per-class precision/recall, then VOC AP — either the 11-point 2007
metric or the continuous AUC metric.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter / union) if union else 0.0


def calc_detection_voc_ap(prec, rec, use_07_metric=False) -> np.ndarray:
    """Per-class AP from precision/recall curves (chainercv-compatible)."""
    n = len(prec)
    ap = np.empty(n)
    for k in range(n):
        if prec[k] is None or rec[k] is None:
            ap[k] = np.nan
            continue
        if use_07_metric:
            ap[k] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[k] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[k])[rec[k] >= t])
                ap[k] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[k]), [0]))
            mrec = np.concatenate(([0], rec[k], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[k] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


class VOCEvaluation:
    """Streaming accumulator for the VOC instance-seg metric: feed one image
    at a time with ``add()`` (only per-class score/match lists are retained,
    never the masks), then ``results()``. Per-image matching is identical to
    ``eval_instseg_voc``."""

    def __init__(self, iou_thresh: float = 0.5, use_07_metric: bool = False):
        self.iou_thresh = iou_thresh
        self.use_07_metric = use_07_metric
        self._n_pos: Dict[int, int] = defaultdict(int)
        self._score: Dict[int, List[float]] = defaultdict(list)
        self._match: Dict[int, List[int]] = defaultdict(list)

    def _ingest_class(self, lbl, scores_desc, iou, diff_l) -> None:
        """Record one (image, class): ``scores_desc`` are the class's
        prediction scores in descending order, ``iou`` the (P, G) matrix in
        that prediction order, ``diff_l`` the class's gt difficult flags.

        Argmax-IoU assignment per prediction (chainercv selec logic): a TP
        requires the argmax gt itself to be unselected — a better-but-taken
        gt does NOT fall through to the next-best gt. Shared by :meth:`add`
        and :meth:`add_boxlocal` so the paste and box-local paths cannot
        diverge in matching semantics."""
        self._n_pos[lbl] += int(np.logical_not(diff_l).sum())
        self._score[lbl].extend(np.asarray(scores_desc).tolist())
        if len(scores_desc) == 0:
            return
        if iou.shape[1] == 0:
            self._match[lbl].extend([0] * len(scores_desc))
            return
        gt_index = iou.argmax(axis=1)
        gt_index[iou.max(axis=1) < self.iou_thresh] = -1
        selec = np.zeros(iou.shape[1], bool)
        for gt_idx in gt_index:
            if gt_idx >= 0:
                if diff_l[gt_idx]:
                    self._match[lbl].append(-1)
                elif not selec[gt_idx]:
                    self._match[lbl].append(1)
                else:
                    self._match[lbl].append(0)
                selec[gt_idx] = True
            else:
                self._match[lbl].append(0)

    def add(self, p_masks, p_labels, p_scores, g_masks, g_labels,
            g_difficult=None):
        p_labels = np.asarray(p_labels)
        p_scores = np.asarray(p_scores)
        g_labels = np.asarray(g_labels)
        if g_difficult is None:
            g_difficult = np.zeros(len(g_labels), bool)
        else:
            g_difficult = np.asarray(g_difficult, bool)
        for lbl in np.unique(
            np.concatenate([p_labels, g_labels]).astype(int)
        ):
            pi = np.flatnonzero(p_labels == lbl)
            gi = np.flatnonzero(g_labels == lbl)
            order = np.argsort(-p_scores[pi], kind="stable")
            pi = pi[order]
            iou = np.array(
                [[mask_iou(p_masks[p], g_masks[g]) for g in gi] for p in pi]
            ).reshape(len(pi), len(gi))
            self._ingest_class(lbl, p_scores[pi], iou, g_difficult[gi])

    def add_boxlocal(self, p_bboxes, p_mask_probs, p_labels, p_scores,
                     im_size, g_masks, g_labels, g_difficult=None):
        """Same matching as :meth:`add` fed with pasted masks, computed
        box-locally: a prediction is zero outside its (expanded, clipped)
        box, so ``IoU = inter / (area_p + area_g - inter)`` needs only the
        gt crop under each detection's box — no full-image canvases."""
        from mask_rcnn_tpu_torch.utils.masks import boxlocal_masks

        im_h, im_w = im_size
        p_labels = np.asarray(p_labels)
        p_scores = np.asarray(p_scores)
        g_labels = np.asarray(g_labels)
        g_masks = (
            np.asarray(g_masks, bool)
            if len(g_labels)
            else np.zeros((0, 1, 1), bool)
        )
        locals_ = (
            boxlocal_masks(
                np.asarray(p_bboxes, np.float32),
                np.asarray(p_mask_probs, np.float32),
                im_h,
                im_w,
            )
            if len(p_labels)
            else []
        )
        # Intersections + areas (C++ when available, numpy oracle fallback)
        # via the core shared with the COCO metric — one implementation, so
        # the two paths cannot diverge.
        from mask_rcnn_tpu_torch.utils.masks import boxlocal_inter_areas

        inter_all, p_areas, g_areas = boxlocal_inter_areas(
            locals_, g_masks, p_labels, g_labels
        )
        if g_difficult is None:
            g_difficult = np.zeros(len(g_labels), bool)
        else:
            g_difficult = np.asarray(g_difficult, bool)
        for lbl in np.unique(
            np.concatenate([p_labels, g_labels]).astype(int)
        ):
            pi = np.flatnonzero(p_labels == lbl)
            gi = np.flatnonzero(g_labels == lbl)
            order = np.argsort(-p_scores[pi], kind="stable")
            pi = pi[order]
            iou = np.zeros((len(pi), len(gi)), np.float64)
            if len(pi) and len(gi):
                inter = inter_all[np.ix_(pi, gi)]
                union = p_areas[pi, None] + g_areas[gi][None, :] - inter
                iou = np.where(
                    union > 0, inter / np.maximum(union, 1), 0.0
                )
            self._ingest_class(lbl, p_scores[pi], iou, g_difficult[gi])

    def get_state(self):
        """Compact picklable state (per-class score/match lists) for
        pooling across evaluation shards."""
        return {
            "n_pos": dict(self._n_pos),
            "score": {k: list(v) for k, v in self._score.items()},
            "match": {k: list(v) for k, v in self._match.items()},
        }

    def merge_state(self, state) -> None:
        """Merge another shard's ``get_state()`` — exact (the metric sorts
        the pooled score lists globally before the PR curve)."""
        for k, v in state["n_pos"].items():
            self._n_pos[k] += v
        for k, v in state["score"].items():
            self._score[k].extend(v)
        for k, v in state["match"].items():
            self._match[k].extend(v)

    def set_state(self, state) -> None:
        """Replace the accumulator with ``state`` (used to rebuild pooled
        records in a rank-independent order)."""
        self._n_pos = defaultdict(int, state["n_pos"])
        self._score = defaultdict(
            list, {k: list(v) for k, v in state["score"].items()}
        )
        self._match = defaultdict(
            list, {k: list(v) for k, v in state["match"].items()}
        )

    def results(self) -> Dict:
        n_fg = max(self._n_pos.keys(), default=-1) + 1
        prec: List = [None] * n_fg
        rec: List = [None] * n_fg
        for lbl in self._n_pos:
            s = np.asarray(self._score[lbl])
            m = np.asarray(self._match[lbl])
            order = np.argsort(-s, kind="stable")
            m = m[order]
            tp = np.cumsum(m == 1)
            fp = np.cumsum(m == 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                prec[lbl] = tp / (tp + fp)
            rec[lbl] = tp / self._n_pos[lbl] if self._n_pos[lbl] > 0 else None

        ap = calc_detection_voc_ap(prec, rec, self.use_07_metric)
        return {"ap": ap, "map": float(np.nanmean(ap))}


def eval_instseg_voc(
    pred_masks,
    pred_labels,
    pred_scores,
    gt_masks,
    gt_labels,
    gt_difficults=None,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict:
    """Returns {'ap': (K,) array, 'map': float}."""
    ev = VOCEvaluation(iou_thresh=iou_thresh, use_07_metric=use_07_metric)
    if gt_difficults is None:
        gt_difficults = [None] * len(gt_masks)
    for args in zip(pred_masks, pred_labels, pred_scores, gt_masks,
                    gt_labels, gt_difficults):
        ev.add(*args)
    return ev.results()
