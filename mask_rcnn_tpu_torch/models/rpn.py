"""Region Proposal Network and proposal generation, the port of
``mask_rcnn_tpu/models/rpn.py``.

3x3 conv + relu, a 1x1 ``loc`` head -> (N, HWA, 4) and a 1x1 ``score`` head
with a single sigmoid foreground logit per anchor -> (N, HWA). Proposals
(chainercv ``ProposalCreator``, min_size 0, test 6000 pre-NMS / 1000
post-NMS, NMS 0.7) are batched over images with static shapes: a stable
descending sort for the top-k, NMS kernel K2, padded output.
"""

from __future__ import annotations

import dataclasses

import torch

from mask_rcnn_tpu_torch.models.resnet import conv2d
from mask_rcnn_tpu_torch.ops.boxes import clip_boxes, loc2bbox
from mask_rcnn_tpu_torch.ops.nms import nms_padded
from mask_rcnn_tpu_torch.ops.tensors import top_k_stable


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """chainercv ProposalCreator parameters."""

    nms_thresh: float = 0.7
    n_train_pre_nms: int = 12000
    n_train_post_nms: int = 2000
    n_test_pre_nms: int = 6000
    n_test_post_nms: int = 1000
    min_size: float = 0.0


def rpn_forward(params, features):
    """Features (N, H, W, C) -> (locs (N, HWA, 4), scores (N, HWA)).

    The heads' outputs are NHWC, so the (H, W, A) flattening is cell-major
    then anchor with loc channel ``a*4 + k``, matching
    ``enumerate_shifted_anchors``.
    """
    n = features.shape[0]
    h = torch.relu(
        conv2d(features, params["conv1"]["W"], padding=1)
        + params["conv1"]["b"]
    )
    locs = conv2d(h, params["loc"]["W"]) + params["loc"]["b"]
    scores = conv2d(h, params["score"]["W"]) + params["score"]["b"]
    return locs.reshape(n, -1, 4), scores.reshape(n, -1)


def init_rpn(gen, in_channels=1024, mid_channels=1024, n_anchor=12,
             std=0.01):
    def conv(kh, kw, cin, cout):
        return {
            "W": torch.randn((cout, cin, kh, kw), generator=gen) * std,
            "b": torch.zeros(cout),
        }

    return {
        "conv1": conv(3, 3, in_channels, mid_channels),
        "loc": conv(1, 1, mid_channels, n_anchor * 4),
        "score": conv(1, 1, mid_channels, n_anchor),
    }


def propose_batch(locs, scores, anchors, img_size, scales,
                  cfg: ProposalConfig, train: bool = False):
    """Proposals for a batch.

    Args:
        locs: (N, HWA, 4) predicted offsets.
        scores: (N, HWA) foreground logits.
        anchors: (HWA, 4) anchor boxes.
        img_size: (H, W) of the padded input.
        scales: (N,) preprocessing scales (for ``min_size``).
        cfg: proposal parameters.
        train: picks train vs test pre/post NMS counts.

    Returns:
        rois (N, n_post, 4) zero-padded, mask (N, n_post) validity.
    """
    n_pre = cfg.n_train_pre_nms if train else cfg.n_test_pre_nms
    n_post = cfg.n_train_post_nms if train else cfg.n_test_post_nms

    roi = clip_boxes(loc2bbox(anchors, locs), img_size)
    hs = roi[..., 2] - roi[..., 0]
    ws = roi[..., 3] - roi[..., 1]
    min_size = (cfg.min_size * scales)[:, None]
    size_ok = (hs >= min_size) & (ws >= min_size)
    masked_score = torch.where(size_ok, scores, -torch.inf)

    k = min(n_pre, scores.shape[1])
    top_scores, top_idx = top_k_stable(masked_score, k)
    top_rois = torch.gather(roi, 1, top_idx[..., None].expand(-1, -1, 4))
    keep_idx, keep_mask = nms_padded(
        top_rois, top_scores, cfg.nms_thresh, n_post,
        valid=torch.isfinite(top_scores), presorted=True,
    )
    rois = torch.gather(
        top_rois, 1, keep_idx.clamp(min=0).long()[..., None].expand(-1, -1, 4)
    )
    rois = torch.where(keep_mask[..., None], rois, 0.0)
    return rois, keep_mask
