"""Native COCO-style evaluation (no pycocotools dependency), the port of
``mask_rcnn_tpu/utils/cocoeval.py``.

Implements the COCOeval 'segm'/'bbox' protocol — greedy score-ordered
matching per (image, category) at 10 IoU thresholds, crowd/ignore handling,
area ranges, maxDets, 101-point interpolated precision — and the reference's
result-dict surface (utils/evaluations/eval_instance_segmentation_coco.py:
20-228): keys like ``ap/iou=0.50:0.95/area=all/maxDets=100`` (per-class
array) and ``m<key>`` (scalar mean).

Masks are compared with packed-bit popcount intersections, so a full
COCO-val-scale evaluation stays tractable on one CPU core.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRESHS = np.linspace(0.5, 0.95, 10)
REC_THRESHS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)

_POPCOUNT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int64)


def _pack(masks: np.ndarray) -> np.ndarray:
    """(R, H, W) bool -> (R, ceil(HW/8)) packed bits."""
    r = masks.shape[0]
    return np.packbits(masks.reshape(r, -1), axis=1)


def mask_iou_matrix(
    det_masks: np.ndarray, gt_masks: np.ndarray, gt_crowd: np.ndarray
) -> np.ndarray:
    """(D, G) mask IoU; crowd gt uses union = det area (COCO semantics)."""
    d, g = det_masks.shape[0], gt_masks.shape[0]
    if d == 0 or g == 0:
        return np.zeros((d, g), np.float64)
    from mask_rcnn_tpu_torch.utils import native

    fast = native.mask_iou_packed(det_masks, gt_masks, gt_crowd)
    if fast is not None:
        return fast
    dp = _pack(det_masks.astype(bool))
    gp = _pack(gt_masks.astype(bool))
    d_area = _POPCOUNT[dp].sum(axis=1)
    g_area = _POPCOUNT[gp].sum(axis=1)
    out = np.zeros((d, g), np.float64)
    for j in range(g):
        inter = _POPCOUNT[np.bitwise_and(dp, gp[j][None])].sum(axis=1)
        union = np.where(gt_crowd[j], d_area, d_area + g_area[j] - inter)
        out[:, j] = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return out


def box_iou_matrix(det, gt, gt_crowd) -> np.ndarray:
    """(D, G) box IoU on (y1, x1, y2, x2); crowd union = det area."""
    d, g = len(det), len(gt)
    if d == 0 or g == 0:
        return np.zeros((d, g), np.float64)
    tl = np.maximum(det[:, None, :2], gt[None, :, :2])
    br = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    d_area = np.prod(np.clip(det[:, 2:] - det[:, :2], 0, None), axis=1)
    g_area = np.prod(np.clip(gt[:, 2:] - gt[:, :2], 0, None), axis=1)
    union = np.where(
        gt_crowd[None, :], d_area[:, None],
        d_area[:, None] + g_area[None, :] - inter,
    )
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _match_image(
    ious: np.ndarray,
    det_scores: np.ndarray,
    gt_ignore: np.ndarray,
    gt_crowd: np.ndarray,
    det_ignore_area: np.ndarray,
    iou_threshs: np.ndarray,
):
    """Greedy COCO matching for one (image, category, areaRng).

    Args:
        ious: (D, G) with dets already sorted by descending score and gts
            sorted ignored-last.
        gt_ignore: (G,) after area-range marking.
        gt_crowd: (G,) crowd flags — only crowd gts may be rematched
            (pycocotools: ``gtm>0 and not iscrowd -> continue``); an
            area-ignored non-crowd gt absorbs at most one det.
        det_ignore_area: (D,) det outside area range.

    Returns (dtm (T, D) matched flag, dt_ig (T, D)).
    """
    from mask_rcnn_tpu_torch.utils import native

    fast = native.coco_match_image(
        ious, gt_ignore, gt_crowd, det_ignore_area, iou_threshs
    )
    if fast is not None:
        return fast

    t_n = len(iou_threshs)
    d_n, g_n = ious.shape
    gtm = -np.ones((t_n, g_n), np.int64)
    dtm = -np.ones((t_n, d_n), np.int64)
    dt_ig = np.zeros((t_n, d_n), bool)
    for ti, t in enumerate(iou_threshs):
        for di in range(d_n):
            best_iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                if gtm[ti, gi] >= 0 and not gt_crowd[gi]:
                    continue
                # gts are sorted ignored-last: stop if we already have an
                # unignored match and remaining gts are ignored
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            dt_ig[ti, di] = gt_ignore[m]
            gtm[ti, m] = di
        dt_ig[ti] |= (dtm[ti] < 0) & det_ignore_area
    return dtm, dt_ig


class COCOEvaluation:
    """Accumulating evaluator.

    Feed per-image predictions/gt with ``add()``, then ``results()`` returns
    the reference-compatible metrics dict.
    """

    def __init__(self, iou_type: str = "segm",
                 class_ids: Optional[Sequence[int]] = None):
        assert iou_type in ("segm", "bbox")
        self.iou_type = iou_type
        self._class_ids = set(class_ids) if class_ids else set()
        self._per_image = []  # (img record) list

    def add(
        self,
        pred_masks,
        pred_labels,
        pred_scores,
        gt_masks,
        gt_labels,
        gt_crowds=None,
        gt_areas=None,
        pred_bboxes=None,
        gt_bboxes=None,
    ):
        """Add one image. Masks are (R, H, W) bool arrays (for 'segm');
        bboxes (R, 4) y1x1y2x2 (for 'bbox')."""
        g = len(gt_labels)
        d = len(pred_labels)
        if gt_crowds is None:
            gt_crowds = np.zeros(g, bool)
        gt_crowds = np.asarray(gt_crowds).astype(bool)
        if self.iou_type == "segm":
            # materialize once per image, not once per category below
            pred_masks = (
                np.asarray(pred_masks, bool)
                if d
                else np.zeros((0, 1, 1), bool)
            )
            gt_masks = (
                np.asarray(gt_masks, bool) if g else np.zeros((0, 1, 1), bool)
            )
            det_area = pred_masks.sum(axis=(1, 2)).astype(np.float64)
            gt_area_dflt = gt_masks.sum(axis=(1, 2)).astype(np.float64)
        else:
            pred_masks = None
            det_area = np.prod(
                np.clip(pred_bboxes[:, 2:] - pred_bboxes[:, :2], 0, None),
                axis=1,
            ) if d else np.zeros(0)
            gt_area_dflt = np.prod(
                np.clip(gt_bboxes[:, 2:] - gt_bboxes[:, :2], 0, None), axis=1
            ) if g else np.zeros(0)
        gt_area = (
            np.asarray(gt_areas, np.float64)
            if gt_areas is not None
            else gt_area_dflt
        )

        order = np.argsort(-np.asarray(pred_scores), kind="stable")
        record = {}
        cats = set(np.asarray(pred_labels).tolist()) | set(
            np.asarray(gt_labels).tolist()
        )
        self._class_ids |= cats
        for cat in cats:
            d_sel = order[np.asarray(pred_labels)[order] == cat]
            g_sel = np.flatnonzero(np.asarray(gt_labels) == cat)
            if self.iou_type == "segm":
                if len(d_sel) == 0 or len(g_sel) == 0:
                    ious = np.zeros((len(d_sel), len(g_sel)), np.float64)
                else:
                    ious = mask_iou_matrix(
                        pred_masks[d_sel], gt_masks[g_sel],
                        gt_crowds[g_sel],
                    )
            else:
                ious = box_iou_matrix(
                    pred_bboxes[d_sel] if len(d_sel) else np.zeros((0, 4)),
                    gt_bboxes[g_sel] if len(g_sel) else np.zeros((0, 4)),
                    gt_crowds[g_sel],
                )
            record[cat] = {
                "ious": ious,
                "det_scores": np.asarray(pred_scores)[d_sel],
                "det_areas": det_area[d_sel],
                "gt_areas": gt_area[g_sel],
                "gt_crowds": gt_crowds[g_sel],
            }
        self._per_image.append(record)

    def add_boxlocal(
        self,
        pred_bboxes,
        pred_mask_probs,
        pred_labels,
        pred_scores,
        im_size,
        gt_masks,
        gt_labels,
        gt_crowds=None,
        gt_areas=None,
    ):
        """Streaming 'segm' ingestion straight from (box, roi-probs) pairs.

        Produces records identical to :meth:`add` fed with
        ``paste_masks(pred_bboxes, pred_mask_probs, ...)`` — a predicted
        mask is zero outside its (expanded, clipped) box, so every
        intersection and area is an integer count over exactly the pixels
        the paste would have written, computed box-locally. Skips the
        full-image canvases (the dominant host cost of an evaluation
        sweep) and intersects gt only inside each detection's box.
        """
        assert self.iou_type == "segm"
        from mask_rcnn_tpu_torch.utils.masks import boxlocal_masks

        im_h, im_w = im_size
        d = len(pred_labels)
        g = len(gt_labels)
        if gt_crowds is None:
            gt_crowds = np.zeros(g, bool)
        gt_crowds = np.asarray(gt_crowds).astype(bool)
        gt_masks = (
            np.asarray(gt_masks, bool) if g else np.zeros((0, 1, 1), bool)
        )
        locals_ = (
            boxlocal_masks(
                np.asarray(pred_bboxes, np.float32),
                np.asarray(pred_mask_probs, np.float32),
                im_h,
                im_w,
            )
            if d
            else []
        )
        # Intersections + areas (C++ when available, numpy oracle fallback)
        # via the core shared with the VOC metric — one implementation, so
        # the two paths cannot diverge.
        from mask_rcnn_tpu_torch.utils.masks import boxlocal_inter_areas

        inter_all, det_area, gt_area_mask = boxlocal_inter_areas(
            locals_, gt_masks, pred_labels, gt_labels
        )
        gt_area = (
            np.asarray(gt_areas, np.float64)
            if gt_areas is not None
            else gt_area_mask.astype(np.float64)
        )

        order = np.argsort(-np.asarray(pred_scores), kind="stable")
        record = {}
        cats = set(np.asarray(pred_labels).tolist()) | set(
            np.asarray(gt_labels).tolist()
        )
        self._class_ids |= cats
        for cat in cats:
            d_sel = order[np.asarray(pred_labels)[order] == cat]
            g_sel = np.flatnonzero(np.asarray(gt_labels) == cat)
            ious = np.zeros((len(d_sel), len(g_sel)), np.float64)
            if len(d_sel) and len(g_sel):
                inter = inter_all[np.ix_(d_sel, g_sel)]
                union = np.where(
                    gt_crowds[g_sel][None, :],
                    det_area[d_sel, None],
                    det_area[d_sel, None] + gt_area_mask[g_sel][None, :]
                    - inter,
                )
                ious = np.where(
                    union > 0, inter / np.maximum(union, 1), 0.0
                )
            record[cat] = {
                "ious": ious,
                "det_scores": np.asarray(pred_scores)[d_sel],
                "det_areas": det_area[d_sel].astype(np.float64),
                "gt_areas": gt_area[g_sel],
                "gt_crowds": gt_crowds[g_sel],
            }
        self._per_image.append(record)

    # -- distributed pooling ------------------------------------------------
    def get_state(self):
        """Compact picklable state (per-image match records) for pooling
        across evaluation shards."""
        return {"class_ids": self._class_ids, "per_image": self._per_image}

    def merge_state(self, state) -> None:
        """Merge another shard's ``get_state()`` — exact: per-image records
        are independent, so pooling then scoring equals scoring the union
        of images in one process."""
        self._class_ids |= set(state["class_ids"])
        self._per_image.extend(state["per_image"])

    def set_state(self, state) -> None:
        """Replace the accumulator with ``state`` (used to rebuild pooled
        records in a rank-independent order)."""
        self._class_ids = set(state["class_ids"])
        self._per_image = list(state["per_image"])

    def _evaluate_all(self):
        """-> eval structures: per (cat, area, maxDet) concatenated scores,
        tp/fp flags; then precision/recall tables."""
        cat_list = sorted(self._class_ids)
        k_n = len(cat_list)
        a_names = list(AREA_RANGES)
        t_n = len(IOU_THRESHS)
        r_n = len(REC_THRESHS)
        m_n = len(MAX_DETS)
        precision = -np.ones((t_n, r_n, k_n, len(a_names), m_n))
        recall = -np.ones((t_n, k_n, len(a_names), m_n))

        for ki, cat in enumerate(cat_list):
            for ai, a_name in enumerate(a_names):
                lo, hi = AREA_RANGES[a_name]
                # per-image matching at the largest maxDet, reused for all
                per_img = []
                for rec in self._per_image:
                    if cat not in rec:
                        continue
                    r = rec[cat]
                    max_det = MAX_DETS[-1]
                    ious = r["ious"][:max_det]
                    scores = r["det_scores"][:max_det]
                    det_areas = r["det_areas"][:max_det]
                    gt_ig = r["gt_crowds"] | (
                        (r["gt_areas"] < lo) | (r["gt_areas"] > hi)
                    )
                    gt_order = np.argsort(gt_ig, kind="stable")
                    ious_s = ious[:, gt_order]
                    gt_ig_s = gt_ig[gt_order]
                    gt_crowd_s = r["gt_crowds"][gt_order]
                    det_out = (det_areas < lo) | (det_areas > hi)
                    dtm, dt_ig = _match_image(
                        ious_s, scores, gt_ig_s, gt_crowd_s, det_out,
                        IOU_THRESHS,
                    )
                    per_img.append(
                        {
                            "scores": scores,
                            "dtm": dtm,
                            "dt_ig": dt_ig,
                            "n_gt": int((~gt_ig_s).sum()),
                        }
                    )
                if not per_img:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [p["scores"][:max_det] for p in per_img]
                    )
                    dtm = np.concatenate(
                        [p["dtm"][:, :max_det] for p in per_img], axis=1
                    )
                    dt_ig = np.concatenate(
                        [p["dt_ig"][:, :max_det] for p in per_img], axis=1
                    )
                    n_gt = sum(p["n_gt"] for p in per_img)
                    if n_gt == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = dtm[:, order]
                    dt_ig = dt_ig[:, order]
                    tps = (dtm >= 0) & ~dt_ig
                    fps = (dtm < 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t_n):
                        tp = tp_sum[ti]
                        fp = fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone non-increasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRESHS, side="left")
                        q = np.zeros(r_n)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        return cat_list, precision, recall

    def results(self) -> Dict:
        """Reference-compatible results dict (per-class arrays under
        'ap/...' keys, scalar means under 'map/...' = 'm'+key)."""
        cat_list, precision, recall = self._evaluate_all()
        out = {"class_ids": cat_list}

        def summarize(ap, iou_thresh, area, max_det):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            if ap:
                s = precision
                if iou_thresh is not None:
                    ti = int(np.argmin(np.abs(IOU_THRESHS - iou_thresh)))
                    s = s[ti:ti + 1]
                s = s[:, :, :, ai, mi]
            else:
                s = recall
                if iou_thresh is not None:
                    ti = int(np.argmin(np.abs(IOU_THRESHS - iou_thresh)))
                    s = s[ti:ti + 1]
                s = s[:, :, ai, mi]
            s = s.astype(np.float64).copy()
            s[s == -1] = np.nan
            s = s.reshape(-1, s.shape[-1] if s.ndim > 1 else 1)
            if s.ndim == 1:
                s = s[:, None]
            valid = np.any(~np.isnan(s), axis=0)
            class_s = np.full(s.shape[1], np.nan)
            if valid.any():
                class_s[valid] = np.nanmean(s[:, valid], axis=0)
                mean_s = float(np.nanmean(class_s))
            else:
                mean_s = float("nan")
            return class_s, mean_s

        specs = {
            "ap/iou=0.50:0.95/area=all/maxDets=100": (True, None, "all", 100),
            "ap/iou=0.50/area=all/maxDets=100": (True, 0.5, "all", 100),
            "ap/iou=0.75/area=all/maxDets=100": (True, 0.75, "all", 100),
            "ap/iou=0.50:0.95/area=small/maxDets=100": (
                True, None, "small", 100),
            "ap/iou=0.50:0.95/area=medium/maxDets=100": (
                True, None, "medium", 100),
            "ap/iou=0.50:0.95/area=large/maxDets=100": (
                True, None, "large", 100),
            "ar/iou=0.50:0.95/area=all/maxDets=1": (False, None, "all", 1),
            "ar/iou=0.50:0.95/area=all/maxDets=10": (False, None, "all", 10),
            "ar/iou=0.50:0.95/area=all/maxDets=100": (
                False, None, "all", 100),
            "ar/iou=0.50:0.95/area=small/maxDets=100": (
                False, None, "small", 100),
            "ar/iou=0.50:0.95/area=medium/maxDets=100": (
                False, None, "medium", 100),
            "ar/iou=0.50:0.95/area=large/maxDets=100": (
                False, None, "large", 100),
        }
        for key, (ap, iou, area, md) in specs.items():
            class_s, mean_s = summarize(ap, iou, area, md)
            out[key] = class_s
            out["m" + key] = mean_s
        return out


def eval_instseg_coco(
    pred_masks, pred_labels, pred_scores,
    gt_masks, gt_labels, gt_crowds=None, gt_areas=None,
) -> Dict:
    """Reference ``eval_instseg_coco`` surface on iterables of per-image
    arrays."""
    ev = COCOEvaluation("segm")
    n = len(pred_labels)
    gt_crowds = gt_crowds if gt_crowds is not None else [None] * n
    gt_areas = gt_areas if gt_areas is not None else [None] * n
    for i in range(n):
        ev.add(
            pred_masks[i], pred_labels[i], pred_scores[i],
            gt_masks[i], gt_labels[i], gt_crowds[i], gt_areas[i],
        )
    return ev.results()
