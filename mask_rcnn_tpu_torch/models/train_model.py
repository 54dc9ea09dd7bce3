"""The 5-term Mask R-CNN training loss, the port of
``mask_rcnn_tpu/models/train_model.py``.

The per-image target creators run batched (``models/targets.py``, kernels
K8 and K9); proposals come from the detached RPN outputs through K2 at the
train counts; the head's pooler runs K1/K7 (RoIAlign), K5/K11
(crop-and-resize) or K6/K12 (max RoI pooling), forward/backward. Padded
and unfilled slots carry label -1, which every loss ignores and excludes
from its normalizer, so the padded static-shape losses equal the
reference's ragged ones.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mask_rcnn_tpu_torch.models import heads, rpn
from mask_rcnn_tpu_torch.models.mask_rcnn import (
    MaskRCNNConfig,
    cast_params,
    forward_backbone_rpn,
    set_float32_precision,
)
from mask_rcnn_tpu_torch.models.targets import (
    AnchorTargetConfig,
    ProposalTargetConfig,
    anchor_targets,
    proposal_targets,
)
from mask_rcnn_tpu_torch.ops.losses import (
    fast_rcnn_loc_loss,
    sigmoid_cross_entropy,
    softmax_cross_entropy,
)
from mask_rcnn_tpu_torch.ops.tensors import constant


def train_loss(
    params,
    cfg: MaskRCNNConfig,
    batch: Dict[str, torch.Tensor],
    generator_or_priorities,
    rpn_sigma: float = 3.0,
    roi_sigma: float = 1.0,
    anchor_cfg: AnchorTargetConfig = AnchorTargetConfig(),
    proposal_cfg: ProposalTargetConfig = ProposalTargetConfig(),
    data_parallel=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Compute the 5-term Mask R-CNN loss on a padded batch.

    Args:
        params: float32 master parameters; they are cast to
            ``cfg.compute_dtype`` here, so their gradients land on them in
            float32.
        batch: image (N, H, W, 3) float32 mean-subtracted, or uint8 raw
            pixels (normalized here); bbox (N, G, 4) float32; label (N, G)
            0-based fg; bbox_valid (N, G) bool; mask (N, G, H, W) binary or
            (N, G, H, W/8) bit-packed uint8; scale (N,) float32. All on one
            device.
        generator_or_priorities: a ``torch.Generator`` on that device for
            the target creators' sampling priorities, or the priorities
            themselves: ``{"proposal": (pos, neg), "anchor": (pos, neg)}``
            of uniform (N, P + G) and (N, S) tensors.
        data_parallel: ``None`` for one process, or the hook of
            ``parallel/mesh.py::DataParallel`` when this batch is one
            rank's slice of a global batch: the priorities are drawn (or
            given) for the global batch and this rank keeps its rows, and
            each loss is this rank's sum over the count of the global
            batch (all-reduced), so the ranks' losses and gradients SUM to
            the global batch's.

    Returns:
        (loss, metrics) with the five terms and their sum.
    """
    set_float32_precision()
    images = batch["image"]
    if images.dtype == torch.uint8:
        images = images.float() - constant(tuple(cfg.mean), images.device)
    n = images.shape[0]
    img_size = tuple(images.shape[1:3])
    if isinstance(generator_or_priorities, torch.Generator):
        gen, priorities = generator_or_priorities, {}
    else:
        gen, priorities = None, generator_or_priorities
    rows = None if data_parallel is None else data_parallel.rows(n)

    # Masks arrive bit-packed along W (pack_mask_bits); K8 reads either.
    mask_packed = batch["mask"].shape[-1] * 8 == img_size[1]

    params = cast_params(params, cfg.compute_dtype)
    feats, rpn_locs, rpn_scores, anchors = forward_backbone_rpn(
        params, cfg, images, train=True
    )

    s = proposal_cfg.n_sample
    with torch.no_grad():
        # Proposals are created from detached RPN outputs (reference
        # region_proposal_network.py:137: `rpn_locs[i].array`).
        rois, rois_valid = rpn.propose_batch(
            rpn_locs.detach().float(), rpn_scores.detach().float(), anchors,
            img_size, batch["scale"], cfg.proposal, train=True,
        )
        sample_rois, gt_locs, gt_labels, gt_masks = proposal_targets(
            rois, rois_valid, batch["bbox"], batch["label"],
            batch["bbox_valid"], batch["mask"], proposal_cfg,
            cfg.loc_normalize_mean, cfg.loc_normalize_std,
            mask_packed=mask_packed, priorities=priorities.get("proposal"),
            generator=gen, rows=rows,
        )
        gt_rpn_locs, gt_rpn_labels = anchor_targets(
            batch["bbox"], batch["bbox_valid"], anchors, img_size,
            anchor_cfg, priorities=priorities.get("anchor"), generator=gen,
            rows=rows,
        )

    # Only positives carry mask targets, and proposal_targets compacts them
    # into the first q slots per image: the mask branch runs on those rows.
    q = min(int(round(s * proposal_cfg.pos_ratio)), s)
    dev = images.device
    mask_subset = (torch.arange(n, device=dev)[:, None] * s
                   + torch.arange(q, device=dev)[None, :]).reshape(-1)
    head_out = heads.head_forward(
        params["head"], feats, sample_rois, roi_size=cfg.roi_size,
        spatial_scale=1.0 / cfg.feat_stride, pred_bbox=True, pred_mask=True,
        pooling=cfg.pooling, sampling_ratio=cfg.sampling_ratio,
        mask_subset=mask_subset,
    )

    q_masks = gt_masks[:, :q].reshape(n * q, cfg.mask_size, cfg.mask_size)
    rpn_n = head_n = mask_n = None
    if data_parallel is not None:
        # The normalizers count over the global batch: one all-reduce of
        # the three counts (no gradient flows through them).
        counts = torch.stack([
            torch.sum((gt_rpn_labels >= 0).float()),
            torch.sum((gt_labels >= 0).float()),
            torch.sum((q_masks >= 0).float()),
        ])
        rpn_n, head_n, mask_n = data_parallel.all_reduce(counts)

    # ---- RPN losses ----
    rpn_loc_loss = fast_rcnn_loc_loss(
        rpn_locs.reshape(-1, 4).float(), gt_rpn_locs.reshape(-1, 4),
        gt_rpn_labels.reshape(-1), rpn_sigma, denom=rpn_n,
    )
    rpn_cls_loss = sigmoid_cross_entropy(
        rpn_scores.reshape(-1).float(), gt_rpn_labels.reshape(-1),
        denom=rpn_n,
    )

    # ---- Head losses ----
    gt_labels_flat = gt_labels.reshape(-1)
    cls_locs = head_out["cls_locs"].float().reshape(n * s, cfg.n_class, 4)
    picked_locs = torch.gather(
        cls_locs, 1,
        torch.clamp(gt_labels_flat, min=0)[:, None, None].expand(-1, 1, 4),
    )[:, 0, :]
    roi_loc_loss = fast_rcnn_loc_loss(
        picked_locs, gt_locs.reshape(-1, 4), gt_labels_flat, roi_sigma,
        denom=head_n,
    )
    roi_cls_loss = softmax_cross_entropy(
        head_out["scores"].float(), gt_labels_flat, denom=head_n,
    )

    # Mask loss over the positive-candidate slots only: the other slots are
    # all -1 (ignored) and add nothing to the sum or the normalizer.
    m = cfg.mask_size
    mask_logits = head_out["masks"].float()  # (N*q, M, M, n_fg)
    sel = torch.clamp(gt_labels[:, :q].reshape(-1) - 1, min=0)
    picked_masks = torch.gather(
        mask_logits, -1, sel[:, None, None, None].expand(-1, m, m, 1)
    )[..., 0]
    roi_mask_loss = sigmoid_cross_entropy(picked_masks, q_masks,
                                          denom=mask_n)

    loss = (
        rpn_loc_loss
        + rpn_cls_loss
        + roi_loc_loss
        + roi_cls_loss
        + roi_mask_loss
    )
    metrics = {
        "rpn_loc_loss": rpn_loc_loss,
        "rpn_cls_loss": rpn_cls_loss,
        "roi_loc_loss": roi_loc_loss,
        "roi_cls_loss": roi_cls_loss,
        "roi_mask_loss": roi_mask_loss,
        "loss": loss,
    }
    return loss, metrics
