"""Training target creation, the port of ``mask_rcnn_tpu/models/targets.py``,
batched over images (the JAX package's ``vmap`` written out).

Matching runs in kernel K9 and the mask crop-resize in kernel K8
(``ops/targets.py``); sampling without replacement stays torch ops: iid
uniform priorities over the candidates, a stable top-k (``lax.top_k``'s tie
order), and ranks below the quota accepted.

**Priorities are injectable.** ``jax.random`` bits cannot be reproduced in
torch, so each creator takes ``priorities``, a pair (positives, negatives)
of uniform [0, 1) tensors shaped like the candidate set, or else draws them
from ``generator`` on the tensors' device. The parity tests draw them with
``jax.random.uniform`` on the JAX package's keys and hand them to both.

Unfilled slots carry label -1, which the losses ignore and exclude from
their normalizers.
"""

from __future__ import annotations

import dataclasses

import torch

from mask_rcnn_tpu_torch.models.mask_rcnn import _constant
from mask_rcnn_tpu_torch.models.rpn import top_k_stable
from mask_rcnn_tpu_torch.ops.boxes import bbox2loc
from mask_rcnn_tpu_torch.ops.targets import (
    anchor_match,
    mask_crop_resize,
    proposal_match,
)


def _priorities(priorities, generator, shape, device):
    if priorities is not None:
        return priorities
    return tuple(torch.rand(shape, generator=generator, device=device)
                 for _ in range(2))


def _sample_masked(priority, candidate_mask, k_static):
    """Uniform sample of up to ``k_static`` True positions per row of a
    (N, S) mask, given (N, S) uniform priorities.

    Returns (idx (N, k), picked (N, k) bool), k = min(k_static, S). Fewer
    than k candidates -> all candidates picked.
    """
    priority = torch.where(candidate_mask, priority, -torch.inf)
    k = min(k_static, candidate_mask.shape[-1])
    top, idx = top_k_stable(priority, k)
    return idx, torch.isfinite(top)


def _gather_rows(x, idx):
    """x (N, S, K), idx (N, D) -> (N, D, K)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


@dataclasses.dataclass(frozen=True)
class AnchorTargetConfig:
    """chainercv AnchorTargetCreator defaults."""

    n_sample: int = 256
    pos_iou_thresh: float = 0.7
    neg_iou_thresh: float = 0.3
    pos_ratio: float = 0.5


def anchor_targets(bbox, bbox_valid, anchors, img_size,
                   cfg: AnchorTargetConfig = AnchorTargetConfig(),
                   priorities=None, generator=None):
    """RPN training targets for a batch.

    Args:
        bbox: (N, G, 4) padded gt boxes; bbox_valid: (N, G) validity.
        anchors: (S, 4) all anchors.
        img_size: (H, W) of the padded input image.
        cfg: sampling parameters.
        priorities: optional pair of (N, S) uniform tensors (positives,
            negatives); else drawn from ``generator``.

    Returns:
        loc: (N, S, 4) regression targets (garbage where label != 1).
        label: (N, S) int32 in {-1 ignore, 0 neg, 1 pos}.
    """
    n, s = bbox.shape[0], anchors.shape[0]
    argmax, label = anchor_match(anchors, bbox, bbox_valid, img_size,
                                 cfg.pos_iou_thresh, cfg.neg_iou_thresh)
    pri_pos, pri_neg = _priorities(priorities, generator, (n, s),
                                   anchors.device)

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

    loc = bbox2loc(anchors, _gather_rows(bbox, argmax))
    return loc, label


@dataclasses.dataclass(frozen=True)
class ProposalTargetConfig:
    """Reference ProposalTargetCreator defaults."""

    n_sample: int = 512
    pos_ratio: float = 0.25
    pos_iou_thresh: float = 0.5
    neg_iou_thresh_hi: float = 0.5
    neg_iou_thresh_lo: float = 0.0
    mask_size: int = 14


def proposal_targets(roi, roi_valid, bbox, label, bbox_valid, mask,
                     cfg: ProposalTargetConfig = ProposalTargetConfig(),
                     loc_normalize_mean=(0.0, 0.0, 0.0, 0.0),
                     loc_normalize_std=(0.1, 0.1, 0.2, 0.2),
                     mask_packed: bool = False, priorities=None,
                     generator=None):
    """Sample rois and build the head's training targets for a batch.

    Args:
        roi: (N, P, 4) padded proposals; roi_valid: (N, P) validity.
        bbox: (N, G, 4) padded gt boxes; label: (N, G) gt fg-class labels
            in [0, n_fg); bbox_valid: (N, G) validity.
        mask: (N, G, H, W) binary instance masks at the padded image's
            resolution, or (N, G, H, W/8) bit-packed when ``mask_packed``.
        priorities: optional pair of (N, P + G) uniform tensors
            (positives, negatives); else drawn from ``generator``.

    Returns:
        sample_roi: (N, n_sample, 4), positives first.
        gt_loc: (N, n_sample, 4) normalized regression targets.
        gt_label: (N, n_sample) int64 in [0, n_class); -1 for unused slots.
        gt_mask: (N, n_sample, mask_size, mask_size) int32 {0, 1}; -1
            everywhere for non-positive slots.
    """
    ns = cfg.n_sample
    dev = roi.device
    # The reference concatenates the gt boxes into the candidate pool.
    cand = torch.cat([roi, bbox], dim=1)
    cand_valid = torch.cat([roi_valid, bbox_valid], dim=1)
    n, p = cand_valid.shape
    gt_assignment, pos_cand, neg_cand = proposal_match(
        cand, cand_valid, bbox, bbox_valid, cfg.pos_iou_thresh,
        cfg.neg_iou_thresh_hi, cfg.neg_iou_thresh_lo)
    pri_pos, pri_neg = _priorities(priorities, generator, (n, p), dev)

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

    sample_roi = _gather_rows(cand, sel_idx)
    sel_gt = torch.gather(gt_assignment, 1, sel_idx)
    gt_roi_label = torch.gather(label.to(torch.int64), 1, sel_gt) + 1
    gt_roi_label = torch.where(sel_pos, gt_roi_label, 0)
    gt_roi_label = torch.where(sel_valid, gt_roi_label, -1)

    gt_loc = bbox2loc(sample_roi, _gather_rows(bbox, sel_gt))
    gt_loc = ((gt_loc - _constant(tuple(loc_normalize_mean), dev))
              / _constant(tuple(loc_normalize_std), dev))

    # Only positives carry mask targets, and the compaction above puts them
    # all in the first pos_quota slots: crop-resize just those rois.
    n_crop = min(pos_quota, ns)
    crops = mask_crop_resize(
        mask, sel_gt[:, :n_crop].contiguous(),
        sample_roi[:, :n_crop].contiguous(), cfg.mask_size,
        packed=mask_packed,
    )
    m = cfg.mask_size
    gt_mask = torch.full((n, ns, m, m), -1, dtype=torch.int32, device=dev)
    gt_mask[:, :n_crop] = torch.where(sel_pos[:, :n_crop, None, None],
                                      crops, -1)
    return sample_roi, gt_loc, gt_roi_label, gt_mask
