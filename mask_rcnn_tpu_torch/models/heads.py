"""C4 RoI head: res5 + box/class/mask branches, the port of
``mask_rcnn_tpu/models/heads.py`` on grouped rois.

RoIAlign (kernel K1) -> res5 -> 7x7 mean -> linear cls_loc (n_class*4) /
score (n_class); mask branch: relu(deconv 2x2/2: 2048 -> 256) -> 1x1 conv ->
n_fg_class logits. Outputs are NHWC and flat over rois, roi-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mask_rcnn_tpu_torch.models.resnet import (
    conv2d,
    init_res5,
    nchw,
    nhwc,
    res5_forward,
)
from mask_rcnn_tpu_torch.ops.roi_align import roi_align_grouped


def deconv2x2_s2(x, w, b):
    """(N, H, W, C) -> (N, 2H, 2W, O); w is conv_transpose2d's (C, O, 2, 2)."""
    return nhwc(F.conv_transpose2d(nchw(x), w, b, stride=2))


def head_forward(params, features, rois, roi_size=14,
                 spatial_scale=1.0 / 16, pred_bbox=True, pred_mask=True,
                 sampling_ratio=0):
    """Run the RoI head on rois grouped per image.

    Args:
        features: (N, H, W, C) C4 features.
        rois: (N, R, 4) float32 boxes in input-image coordinates.

    With ``roi_size = 7*s`` and s > 1 the caffe-convention res5 reads only
    every s-th pooled cell (its stride sits on 1x1 convs), so only those
    bins are pooled (``bin_stride=s``) and res5 runs at stride 1: identical
    values for 1/s^2 of the pooling work
    (mask_rcnn_tpu/models/heads.py:67-86).

    Returns dict with any of cls_locs (N*R, n_class*4), scores
    (N*R, n_class), masks (N*R, 14, 14, n_fg_class) logits.
    """
    s5 = roi_size // 7
    size, bin_stride = (7, s5) if s5 > 1 else (roi_size, 1)
    pool = roi_align_grouped(features, rois, size, spatial_scale,
                             sampling_ratio, bin_stride)
    h = res5_forward(params["res5"],
                     pool.reshape(-1, size, size, features.shape[-1]),
                     stride=1)

    out = {}
    if pred_bbox:
        p5 = h.mean(dim=(1, 2))  # == 7x7 average pooling
        out["cls_locs"] = p5 @ params["cls_loc"]["W"] + params["cls_loc"]["b"]
        out["scores"] = p5 @ params["score"]["W"] + params["score"]["b"]
    if pred_mask:
        d = torch.relu(
            deconv2x2_s2(h, params["deconv6"]["W"], params["deconv6"]["b"])
        )
        out["masks"] = conv2d(d, params["mask"]["W"]) + params["mask"]["b"]
    return out


def init_head(gen, n_class, n_layers=50, loc_std=0.001, std=0.01):
    """Reference initializers (mask_rcnn_tpu/models/heads.py:139-180,
    ``initializer='normal'``): Normal(0.001) for cls_loc, Normal(0.01) for
    score, deconv6 and mask."""
    n_fg = n_class - 1
    return {
        "res5": init_res5(gen, n_layers),
        "cls_loc": {
            "W": torch.randn((2048, n_class * 4), generator=gen) * loc_std,
            "b": torch.zeros(n_class * 4),
        },
        "score": {
            "W": torch.randn((2048, n_class), generator=gen) * std,
            "b": torch.zeros(n_class),
        },
        "deconv6": {
            "W": torch.randn((2048, 256, 2, 2), generator=gen) * std,
            "b": torch.zeros(256),
        },
        "mask": {
            "W": torch.randn((n_fg, 256, 1, 1), generator=gen) * std,
            "b": torch.zeros(n_fg),
        },
    }
