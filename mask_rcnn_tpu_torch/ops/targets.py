"""The training target creators' device work: the wrappers of kernels K9a
and K9b (``csrc/targets.cu``) and their plain torch versions.

* :func:`anchor_targets` (K9a): ``mask_rcnn_tpu/models/targets.py::
  anchor_targets`` whole, batched over images: IoU matching of every anchor
  to the gt boxes, the label rules, the uniform sample of positives and
  negatives by given priorities, and the regression targets;
* :func:`proposal_targets` (K9b, with the mask-target crop-resize K8):
  ``proposal_targets`` whole: matching of the rois and gt boxes, the
  sample's slot order, its rois, class labels and normalised locs, and the
  positive slots' mask targets (``_crop_resize_masks_indexed``).

Each is one kernel launch on the card. A CPU tensor takes the plain
version, a CUDA tensor the kernel (or a ``ValueError`` for what the kernel
does not take). The plain versions follow the JAX package op for op, and
the kernels repeat their arithmetic bit for bit: the rules downstream (IoU
thresholds, ``iou == gt_max``, ``interp > 0.5``) are discontinuous, and
the kernels must pick the same samples.

The plain versions' parts, :func:`anchor_match_plain`,
:func:`proposal_match_plain` and :func:`mask_crop_resize_plain`, are also
callable alone on CPU tensors (:func:`anchor_match`,
:func:`proposal_match`, :func:`mask_crop_resize`); on the card they exist
only inside the two kernels.

**Priorities.** Sampling without replacement takes the top-k of iid
uniform priorities over the candidates (``lax.top_k``'s order: larger
first, ties toward the lower index). Both versions take the priorities as
(N, candidates) float32 tensors of finite values, as ``torch.rand`` draws
them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mask_rcnn_tpu_torch.ops import _kernels
from mask_rcnn_tpu_torch.ops.boxes import bbox2loc, bbox_iou
from mask_rcnn_tpu_torch.ops.tensors import (
    constant,
    gather_rows,
    top_k_stable,
)



@dataclasses.dataclass(frozen=True)
class AnchorTargetConfig:
    """chainercv AnchorTargetCreator defaults."""

    n_sample: int = 256
    pos_iou_thresh: float = 0.7
    neg_iou_thresh: float = 0.3
    pos_ratio: float = 0.5


@dataclasses.dataclass(frozen=True)
class ProposalTargetConfig:
    """Reference ProposalTargetCreator defaults."""

    n_sample: int = 512
    pos_ratio: float = 0.25
    pos_iou_thresh: float = 0.5
    neg_iou_thresh_hi: float = 0.5
    neg_iou_thresh_lo: float = 0.0
    mask_size: int = 14


def _check_cuda(t, name, dtype, shape, device):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must be on the CUDA device {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor, got "
                         f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def kernel_limits():
    """The kernels' limits, owned by ``csrc/targets.cu``: (gt boxes an image
    (kept in shared memory), anchors (K9a), rois + gts an image (K9b))."""
    out = (ctypes.c_int * 3)()
    _kernels.lib().mrcnn_targets_limits(out)
    return tuple(out)


def _check_gt(bbox, bbox_valid, n, device, max_gt):
    if bbox.dim() != 3 or bbox.shape[0] != n or bbox.shape[2] != 4:
        raise ValueError(f"gt boxes must be (N, G, 4), got "
                         f"{tuple(bbox.shape)}")
    g = bbox.shape[1]
    if not 1 <= g <= max_gt:
        raise ValueError(f"the kernel takes 1 <= G <= {max_gt} gt boxes")
    _check_cuda(bbox, "gt boxes", torch.float32, (n, g, 4), device)
    _check_cuda(bbox_valid, "gt validity", torch.bool, (n, g), device)
    return g


def _cpu_only(t, name, kernel):
    if t.device.type != "cpu":
        raise ValueError(f"{name} is the plain version only; on the card it "
                         f"runs inside {kernel}")


# --------------------------------------------------------------------------
# The plain versions' parts


def _inside(anchors, img_size):
    h, w = img_size
    return ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
            & (anchors[:, 2] <= h) & (anchors[:, 3] <= w))


def anchor_match_plain(anchors, bbox, bbox_valid, img_size, pos_thresh,
                       neg_thresh):
    """Anchor matching (mask_rcnn_tpu/models/targets.py:76-101).

    anchors (S, 4), bbox (N, G, 4), bbox_valid (N, G) -> (argmax (N, S)
    int64, the matched gt of each anchor; label (N, S) int32 in {-1, 0, 1}
    before sampling).
    """
    n = bbox.shape[0]
    inside = _inside(anchors, img_size)
    iou = bbox_iou(anchors.expand(n, *anchors.shape), bbox)  # (N, S, G)
    iou = torch.where(bbox_valid[:, None, :], iou, -1.0)
    iou = torch.where(inside[None, :, None], iou, -1.0)
    argmax = torch.argmax(iou, dim=-1)
    max_iou = torch.amax(iou, dim=-1)

    # Anchors achieving the per-gt max IoU (ties included), chainercv style.
    gt_max = torch.amax(iou, dim=1, keepdim=True)  # (N, 1, G)
    is_gt_argmax = ((iou == gt_max) & bbox_valid[:, None, :]
                    & (gt_max > 0)).any(dim=-1)

    label = torch.full(max_iou.shape, -1, dtype=torch.int32,
                       device=anchors.device)
    label = torch.where(inside & (max_iou < neg_thresh), 0, label)
    label = torch.where(inside & is_gt_argmax, 1, label)
    label = torch.where(inside & (max_iou >= pos_thresh), 1, label)
    return argmax, label


def anchor_match(anchors, bbox, bbox_valid, img_size, pos_thresh,
                 neg_thresh):
    """:func:`anchor_match_plain` on CPU tensors."""
    _cpu_only(anchors, "anchor_match", "anchor_targets (K9a)")
    return anchor_match_plain(anchors, bbox, bbox_valid, img_size,
                              pos_thresh, neg_thresh)


def proposal_match_plain(cand, cand_valid, bbox, bbox_valid, pos_thresh,
                         neg_thresh_hi, neg_thresh_lo):
    """Proposal matching (mask_rcnn_tpu/models/targets.py:276-298).

    cand (N, P, 4), cand_valid (N, P), bbox (N, G, 4), bbox_valid (N, G) ->
    (argmax (N, P) int64, the matched gt; pos (N, P) bool, positive
    candidates; neg (N, P) bool, negative candidates). An image with no
    valid gt makes every valid candidate IoU-0 background.
    """
    iou = bbox_iou(cand, bbox)
    iou = torch.where(bbox_valid[:, None, :], iou, -1.0)
    argmax = torch.argmax(iou, dim=-1)
    no_gt_iou = torch.where(bbox_valid.any(dim=-1, keepdim=True), -1.0, 0.0)
    max_iou = torch.where(
        cand_valid, torch.maximum(torch.amax(iou, dim=-1), no_gt_iou), -1.0
    )
    pos = max_iou >= pos_thresh
    neg = (max_iou < neg_thresh_hi) & (max_iou >= neg_thresh_lo)
    return argmax, pos, neg


def proposal_match(cand, cand_valid, bbox, bbox_valid, pos_thresh,
                   neg_thresh_hi, neg_thresh_lo):
    """:func:`proposal_match_plain` on CPU tensors."""
    _cpu_only(cand, "proposal_match", "proposal_targets (K9b)")
    return proposal_match_plain(cand, cand_valid, bbox, bbox_valid,
                                pos_thresh, neg_thresh_hi, neg_thresh_lo)


def mask_sample_coords(rois, size, out_size):
    """cv2-parity bilinear sample positions of rounded roi crops
    (mask_rcnn_tpu/models/targets.py::_mask_sample_coords), batched: rois
    (..., 4) -> y0, y1, x0, x1 (..., out) int64 and ly, lx (..., out)
    float32.

    The roi is rounded half to even (like ``np.round``); cv2 samples at
    ``(i + .5) * crop/out - .5``. Exact-0.5 ties (a sample midway between
    two mask rows) binarise by the last bit of this coordinate, so the
    kernel computes it in the same order, and both divide by a tensor (on
    CUDA a division by a Python scalar is a multiply by its reciprocal).
    """
    h, w = size
    r = torch.round(rois).to(torch.int64)
    i = torch.arange(out_size, dtype=torch.float32, device=rois.device)

    def axis(start, end, size):
        c = torch.clamp(end - start, min=1).to(torch.float32)[..., None]
        v = (i + 0.5) * (c / torch.full_like(c, out_size)) - 0.5
        v = torch.minimum(torch.clamp(v, min=0.0), c - 1.0)
        v = v + start.to(torch.float32)[..., None]
        lo = torch.floor(v).to(torch.int64)
        # The JAX package clamps hi from above only; a roi reaching above
        # or left of the image (which the train path, on clipped proposals
        # and gt boxes, never gives) reads the border instead of out of
        # bounds.
        hi = torch.clamp(lo + 1, 0, size - 1)
        lo = torch.clamp(lo, 0, size - 1)
        return lo, hi, v - lo.to(torch.float32)

    y0, y1, ly = axis(r[..., 0], r[..., 2], h)
    x0, x1, lx = axis(r[..., 1], r[..., 3], w)
    return y0, y1, x0, x1, ly, lx


def mask_crop_resize_plain(masks, gt_index, rois, out_size, packed=False):
    """Mask-target crop-resize, K8's function
    (mask_rcnn_tpu/models/targets.py:190-238), batched.

    masks (N, G, H, W) binary, or (N, G, H, W/8) uint8 bit-packed along W
    (``np.packbits`` order) when ``packed``; gt_index (N, Q) gt of each roi;
    rois (N, Q, 4) -> (N, Q, out, out) int32 in {0, 1}.
    """
    n, g, h, wm = masks.shape
    w = wm * 8 if packed else wm
    q = rois.shape[1]
    y0, y1i, x0, x1i, ly, lx = mask_sample_coords(rois, (h, w), out_size)

    rows2d = masks.reshape(n, g * h, wm)
    base = (gt_index.to(torch.int64) * h)[..., None]
    row_idx = torch.cat([base + y0, base + y1i], dim=-1)  # (N, Q, 2out)
    rows = torch.gather(
        rows2d, 1, row_idx.reshape(n, -1, 1).expand(-1, -1, wm))
    if packed:
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                              device=masks.device)
        rows = ((rows[..., None] >> shifts) & 1).reshape(n, -1, w)
    rows = rows.reshape(n, q, 2 * out_size, w).to(torch.float32)
    r_y0 = rows[:, :, :out_size]  # (N, Q, out, W)
    r_y1 = rows[:, :, out_size:]

    def cols(rws, xx):
        return torch.gather(
            rws, 3, xx[:, :, None, :].expand(n, q, out_size, out_size))

    wy0 = (1 - ly)[..., :, None]
    wy1 = ly[..., :, None]
    wx0 = (1 - lx)[..., None, :]
    wx1 = lx[..., None, :]
    interp = (
        cols(r_y0, x0) * (wy0 * wx0)
        + cols(r_y0, x1i) * (wy0 * wx1)
        + cols(r_y1, x0) * (wy1 * wx0)
        + cols(r_y1, x1i) * (wy1 * wx1)
    )
    return (interp > 0.5).to(torch.int32)


def mask_crop_resize(masks, gt_index, rois, out_size, packed=False):
    """:func:`mask_crop_resize_plain` on CPU tensors."""
    _cpu_only(masks, "mask_crop_resize", "proposal_targets (K9b)")
    return mask_crop_resize_plain(masks, gt_index, rois, out_size, packed)


def _sample_masked(priority, candidate_mask, k_static):
    """Uniform sample of up to ``k_static`` True positions per row of a
    (N, S) mask, given (N, S) uniform priorities.

    Returns (idx (N, k), picked (N, k) bool), k = min(k_static, S): the
    top-k of the masked priorities by a stable descending sort
    (``lax.top_k``'s tie order). Fewer than k candidates -> all candidates
    picked.
    """
    priority = torch.where(candidate_mask, priority, -torch.inf)
    top, idx = top_k_stable(priority, min(k_static, candidate_mask.shape[-1]))
    return idx, torch.isfinite(top)


# --------------------------------------------------------------------------
# K9a: anchor_targets


def anchor_targets_plain(bbox, bbox_valid, anchors, img_size, pri_pos,
                         pri_neg, cfg: AnchorTargetConfig):
    """Plain K9a (mask_rcnn_tpu/models/targets.py::anchor_targets), batched.

    bbox (N, G, 4), bbox_valid (N, G), anchors (S, 4), priorities (N, S)
    each -> (loc (N, S, 4), garbage where label != 1; label (N, S) int32
    in {-1 ignore, 0 neg, 1 pos}).
    """
    n, s = bbox.shape[0], anchors.shape[0]
    argmax, label = anchor_match_plain(anchors, bbox, bbox_valid, img_size,
                                       cfg.pos_iou_thresh,
                                       cfg.neg_iou_thresh)

    # Subsample positives to pos_ratio * n_sample, then negatives to fill.
    n_pos_quota = int(cfg.pos_ratio * cfg.n_sample)
    pos_idx, pos_picked = _sample_masked(pri_pos, label == 1, n_pos_quota)
    n_pos = pos_picked.sum(dim=-1, keepdim=True)
    neg_idx, neg_avail = _sample_masked(pri_neg, label == 0, cfg.n_sample)
    rank = torch.arange(neg_idx.shape[-1], device=anchors.device)
    neg_picked = neg_avail & (rank < cfg.n_sample - n_pos)

    # Anything labeled but not picked gets disabled to -1. Scatter with max
    # (never unset): unpicked top-k slots carry arbitrary indices.
    keep = torch.zeros((n, s), dtype=torch.int32, device=anchors.device)
    keep.scatter_reduce_(1, pos_idx, pos_picked.to(torch.int32), "amax")
    keep.scatter_reduce_(1, neg_idx, neg_picked.to(torch.int32), "amax")
    label = torch.where(keep > 0, label, -1)

    loc = bbox2loc(anchors, gather_rows(bbox, argmax))
    return loc, label


def anchor_targets(bbox, bbox_valid, anchors, img_size, pri_pos, pri_neg,
                   cfg: AnchorTargetConfig):
    """K9a wrapper; see :func:`anchor_targets_plain`. On the card: float32
    anchors, boxes and priorities, bool validity, all contiguous on one
    device, G and S within :func:`kernel_limits`."""
    if anchors.device.type == "cpu":
        return anchor_targets_plain(bbox, bbox_valid, anchors, img_size,
                                    pri_pos, pri_neg, cfg)
    if anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError("anchors must be (S, 4)")
    s = anchors.shape[0]
    max_gt, max_anchors, _ = kernel_limits()
    if not 1 <= s <= max_anchors:
        raise ValueError(f"the kernel takes 1 <= S <= {max_anchors} anchors")
    dev = anchors.device
    _check_cuda(anchors, "anchors", torch.float32, (s, 4), None)
    n = bbox.shape[0]
    g = _check_gt(bbox, bbox_valid, n, dev, max_gt)
    _check_cuda(pri_pos, "positive priorities", torch.float32, (n, s), dev)
    _check_cuda(pri_neg, "negative priorities", torch.float32, (n, s), dev)
    loc = torch.empty((n, s, 4), dtype=torch.float32, device=dev)
    label = torch.empty((n, s), dtype=torch.int32, device=dev)
    h, w = img_size
    err = _kernels.lib().mrcnn_anchor_targets(
        anchors.data_ptr(), bbox.data_ptr(), bbox_valid.data_ptr(),
        pri_pos.data_ptr(), pri_neg.data_ptr(), n, s, g, float(h), float(w),
        float(cfg.pos_iou_thresh), float(cfg.neg_iou_thresh),
        int(cfg.pos_ratio * cfg.n_sample), cfg.n_sample, loc.data_ptr(),
        label.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "mrcnn_anchor_targets")
    anchor_targets.launches += 1
    return loc, label


anchor_targets.launches = 0


# --------------------------------------------------------------------------
# K9b + K8: proposal_targets


def proposal_targets_plain(roi, roi_valid, bbox, label, bbox_valid, mask,
                           pri_pos, pri_neg, cfg: ProposalTargetConfig,
                           loc_normalize_mean, loc_normalize_std,
                           mask_packed=False):
    """Plain K9b + K8 (mask_rcnn_tpu/models/targets.py::proposal_targets),
    batched.

    roi (N, P, 4), roi_valid (N, P); bbox (N, G, 4), label (N, G) in
    [0, n_fg), bbox_valid (N, G); mask (N, G, H, W) binary, or (N, G, H,
    W/8) bit-packed when ``mask_packed``; priorities (N, P + G) each ->
    (sample_roi (N, ns, 4), positives first; gt_loc (N, ns, 4) normalised;
    gt_label (N, ns) int64, -1 for unused slots; gt_mask (N, ns, M, M)
    int32 {0, 1}, -1 everywhere for non-positive slots).
    """
    ns = cfg.n_sample
    dev = roi.device
    # The reference concatenates the gt boxes into the candidate pool.
    cand = torch.cat([roi, bbox], dim=1)
    cand_valid = torch.cat([roi_valid, bbox_valid], dim=1)
    n = cand_valid.shape[0]
    gt_assignment, pos_cand, neg_cand = proposal_match_plain(
        cand, cand_valid, bbox, bbox_valid, cfg.pos_iou_thresh,
        cfg.neg_iou_thresh_hi, cfg.neg_iou_thresh_lo)

    pos_quota = int(round(ns * cfg.pos_ratio))
    pos_idx, pos_picked = _sample_masked(pri_pos, pos_cand, pos_quota)
    n_pos = pos_picked.sum(dim=-1, keepdim=True)
    neg_idx, neg_avail = _sample_masked(pri_neg, neg_cand, ns)
    rank = torch.arange(neg_idx.shape[-1], device=dev)
    neg_picked = neg_avail & (rank < ns - n_pos)

    # Compact [positives..., negatives...] into n_sample slots, positives
    # first, each group in its top-k order.
    all_idx = torch.cat([pos_idx, neg_idx], dim=1)
    all_picked = torch.cat([pos_picked, neg_picked], dim=1)
    is_pos = torch.cat([pos_picked, torch.zeros_like(neg_picked)], dim=1)
    short = ns - all_idx.shape[1]
    if short > 0:  # tiny candidate pools (tests)
        all_idx = torch.nn.functional.pad(all_idx, (0, short))
        all_picked = torch.nn.functional.pad(all_picked, (0, short))
        is_pos = torch.nn.functional.pad(is_pos, (0, short))
    take = torch.sort((~all_picked).to(torch.uint8), dim=1,
                      stable=True).indices[:, :ns]
    sel_idx = torch.gather(all_idx, 1, take)
    sel_valid = torch.gather(all_picked, 1, take)
    sel_pos = torch.gather(is_pos, 1, take)

    sample_roi = gather_rows(cand, sel_idx)
    sel_gt = torch.gather(gt_assignment, 1, sel_idx)
    gt_roi_label = torch.gather(label.to(torch.int64), 1, sel_gt) + 1
    gt_roi_label = torch.where(sel_pos, gt_roi_label, 0)
    gt_roi_label = torch.where(sel_valid, gt_roi_label, -1)

    gt_loc = bbox2loc(sample_roi, gather_rows(bbox, sel_gt))
    gt_loc = ((gt_loc - constant(tuple(loc_normalize_mean), dev))
              / constant(tuple(loc_normalize_std), dev))

    # Only positives carry mask targets, and the compaction above puts them
    # all in the first pos_quota slots: crop-resize just those rois.
    n_crop = min(pos_quota, ns)
    crops = mask_crop_resize_plain(
        mask, sel_gt[:, :n_crop].contiguous(),
        sample_roi[:, :n_crop].contiguous(), cfg.mask_size,
        packed=mask_packed,
    )
    m = cfg.mask_size
    gt_mask = torch.full((n, ns, m, m), -1, dtype=torch.int32, device=dev)
    gt_mask[:, :n_crop] = torch.where(sel_pos[:, :n_crop, None, None],
                                      crops, -1)
    return sample_roi, gt_loc, gt_roi_label, gt_mask


def proposal_targets(roi, roi_valid, bbox, label, bbox_valid, mask, pri_pos,
                     pri_neg, cfg: ProposalTargetConfig, loc_normalize_mean,
                     loc_normalize_std, mask_packed=False):
    """K9b + K8 wrapper; see :func:`proposal_targets_plain`. On the card:
    float32 rois, boxes and priorities, bool validity, int32 labels, uint8
    (or bool, unpacked) masks, all contiguous on one device,
    G and P + G within :func:`kernel_limits`."""
    if roi.device.type == "cpu":
        return proposal_targets_plain(
            roi, roi_valid, bbox, label, bbox_valid, mask, pri_pos, pri_neg,
            cfg, loc_normalize_mean, loc_normalize_std, mask_packed)
    if roi.dim() != 3 or roi.shape[2] != 4:
        raise ValueError("rois must be (N, P, 4)")
    n, p = roi.shape[:2]
    dev = roi.device
    _check_cuda(roi, "rois", torch.float32, (n, p, 4), None)
    _check_cuda(roi_valid, "roi validity", torch.bool, (n, p), dev)
    max_gt, _, max_cand = kernel_limits()
    g = _check_gt(bbox, bbox_valid, n, dev, max_gt)
    if p + g > max_cand:
        raise ValueError(f"the kernel takes P + G <= {max_cand} "
                         f"candidates, got {p + g}")
    _check_cuda(label, "gt labels", torch.int32, (n, g), dev)
    if mask.dim() != 4:
        raise ValueError("masks must be (N, G, H, W) or (N, G, H, W/8)")
    if mask.dtype == torch.bool and not mask_packed:
        mask = mask.view(torch.uint8)
    hm, wm = mask.shape[2:]
    _check_cuda(mask, "masks", torch.uint8, (n, g, hm, wm), dev)
    for pri, name in ((pri_pos, "positive"), (pri_neg, "negative")):
        _check_cuda(pri, f"{name} priorities", torch.float32, (n, p + g),
                    dev)
    ns, m = cfg.n_sample, cfg.mask_size
    if ns < 1 or m < 1:
        raise ValueError("n_sample and mask_size must be >= 1")
    sample_roi = torch.empty((n, ns, 4), dtype=torch.float32, device=dev)
    gt_loc = torch.empty((n, ns, 4), dtype=torch.float32, device=dev)
    gt_label = torch.empty((n, ns), dtype=torch.int64, device=dev)
    gt_mask = torch.empty((n, ns, m, m), dtype=torch.int32, device=dev)
    norm = (ctypes.c_float * 8)(*loc_normalize_mean, *loc_normalize_std)
    err = _kernels.lib().mrcnn_proposal_targets(
        roi.data_ptr(), roi_valid.data_ptr(), bbox.data_ptr(),
        bbox_valid.data_ptr(), label.data_ptr(), mask.data_ptr(),
        pri_pos.data_ptr(), pri_neg.data_ptr(), norm, n, p, g, hm, wm,
        int(bool(mask_packed)),
        float(cfg.pos_iou_thresh), float(cfg.neg_iou_thresh_hi),
        float(cfg.neg_iou_thresh_lo), ns, int(round(ns * cfg.pos_ratio)), m,
        sample_roi.data_ptr(), gt_loc.data_ptr(), gt_label.data_ptr(),
        gt_mask.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "mrcnn_proposal_targets")
    proposal_targets.launches += 1
    return sample_roi, gt_loc, gt_label, gt_mask


proposal_targets.launches = 0
