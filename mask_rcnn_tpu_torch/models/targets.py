"""Training target creation, the port of ``mask_rcnn_tpu/models/targets.py``,
batched over images (the JAX package's ``vmap`` written out).

Each creator is one kernel on the card, K9a and K9b (``ops/targets.py``):
matching, sampling without replacement (iid uniform priorities over the
candidates, a stable top-k in ``lax.top_k``'s tie order, ranks below the
quota accepted), the targets and, for the proposals, the mask crop-resize.

**Priorities are injectable.** ``jax.random`` bits cannot be reproduced in
torch, so each creator takes ``priorities``, a pair (positives, negatives)
of uniform [0, 1) tensors shaped like the candidate set, or else draws them
from ``generator`` on the tensors' device. The parity tests draw them with
``jax.random.uniform`` on the JAX package's keys and hand them to both.

Unfilled slots carry label -1, which the losses ignore and exclude from
their normalizers.
"""

from __future__ import annotations

import torch

from mask_rcnn_tpu_torch.ops import targets as target_ops
from mask_rcnn_tpu_torch.ops.targets import (  # noqa: F401
    AnchorTargetConfig,
    ProposalTargetConfig,
)


def _priorities(priorities, generator, shape, device, rows=None):
    """The (positives, negatives) priorities of ``shape`` = (N, K). With
    ``rows`` = (offset, n_global) the batch is rows [offset, offset + N) of
    a global batch of ``n_global`` images: the priorities are drawn (or
    given) for the whole global batch and these rows are kept, so each
    image samples as it would in one process."""
    if priorities is None:
        n_draw = shape[0] if rows is None else rows[1]
        priorities = tuple(
            torch.rand((n_draw,) + tuple(shape[1:]), generator=generator,
                       device=device) for _ in range(2))
    if rows is None:
        return priorities
    lo, n_global = rows
    for p in priorities:
        if p.shape[0] != n_global:
            raise ValueError(
                f"priorities for {p.shape[0]} images; the global batch has "
                f"{n_global}")
    return tuple(p[lo:lo + shape[0]] for p in priorities)


def anchor_targets(bbox, bbox_valid, anchors, img_size,
                   cfg: AnchorTargetConfig = AnchorTargetConfig(),
                   priorities=None, generator=None, rows=None):
    """RPN training targets for a batch.

    Args:
        bbox: (N, G, 4) padded gt boxes; bbox_valid: (N, G) validity.
        anchors: (S, 4) all anchors.
        img_size: (H, W) of the padded input image.
        cfg: sampling parameters.
        priorities: optional pair of (N, S) uniform tensors (positives,
            negatives); else drawn from ``generator``.
        rows: optional (offset, n_global): the batch is these rows of a
            global batch, whose priorities are drawn or given.

    Returns:
        loc: (N, S, 4) regression targets (garbage where label != 1).
        label: (N, S) int32 in {-1 ignore, 0 neg, 1 pos}.
    """
    n, s = bbox.shape[0], anchors.shape[0]
    pri_pos, pri_neg = _priorities(priorities, generator, (n, s),
                                   anchors.device, rows)
    return target_ops.anchor_targets(bbox, bbox_valid, anchors, img_size,
                                     pri_pos, pri_neg, cfg)


def proposal_targets(roi, roi_valid, bbox, label, bbox_valid, mask,
                     cfg: ProposalTargetConfig = ProposalTargetConfig(),
                     loc_normalize_mean=(0.0, 0.0, 0.0, 0.0),
                     loc_normalize_std=(0.1, 0.1, 0.2, 0.2),
                     mask_packed: bool = False, priorities=None,
                     generator=None, rows=None):
    """Sample rois and build the head's training targets for a batch.

    Args:
        roi: (N, P, 4) padded proposals; roi_valid: (N, P) validity.
        bbox: (N, G, 4) padded gt boxes; label: (N, G) gt fg-class labels
            in [0, n_fg); bbox_valid: (N, G) validity.
        mask: (N, G, H, W) binary instance masks at the padded image's
            resolution, or (N, G, H, W/8) bit-packed when ``mask_packed``.
        priorities: optional pair of (N, P + G) uniform tensors
            (positives, negatives); else drawn from ``generator``.
        rows: optional (offset, n_global), as in :func:`anchor_targets`.

    Returns:
        sample_roi: (N, n_sample, 4), positives first.
        gt_loc: (N, n_sample, 4) normalized regression targets.
        gt_label: (N, n_sample) int64 in [0, n_class); -1 for unused slots.
        gt_mask: (N, n_sample, mask_size, mask_size) int32 {0, 1}; -1
            everywhere for non-positive slots.
    """
    n, p = roi.shape[0], roi.shape[1] + bbox.shape[1]
    pri_pos, pri_neg = _priorities(priorities, generator, (n, p), roi.device,
                                   rows)
    return target_ops.proposal_targets(
        roi, roi_valid, bbox, label, bbox_valid, mask, pri_pos, pri_neg, cfg,
        loc_normalize_mean, loc_normalize_std, mask_packed)
