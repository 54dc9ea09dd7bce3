"""C4 RoI head: res5 + box/class/mask branches, the port of
``mask_rcnn_tpu/models/heads.py`` on grouped rois.

RoI pooling -> res5 -> 7x7 mean -> linear cls_loc (n_class*4) / score
(n_class); mask branch: relu(deconv 2x2/2: 2048 -> 256) -> 1x1 conv ->
n_fg_class logits. Outputs are NHWC and flat over rois, roi-major. The
pooler is the config's ``pooling``: ``"align"`` RoIAlign (kernels K1/K7),
``"resize"`` crop-and-resize (K5/K11) or ``"pooling"`` quantized max RoI
pooling (K6/K12).
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
from mask_rcnn_tpu_torch.ops.roi_align import POOLING_FUNCS, roi_align_grouped


def deconv2x2_s2(x, w, b):
    """(N, H, W, C) -> (N, 2H, 2W, O); w is conv_transpose2d's (C, O, 2, 2)."""
    return nhwc(F.conv_transpose2d(nchw(x), w, b, stride=2))


def head_forward(params, features, rois, roi_size=14,
                 spatial_scale=1.0 / 16, pred_bbox=True, pred_mask=True,
                 pooling="align", sampling_ratio=0, mask_subset=None):
    """Run the RoI head on rois grouped per image.

    Args:
        features: (N, H, W, C) C4 features.
        rois: (N, R, 4) float32 boxes in input-image coordinates.
        pooling: a key of ``POOLING_FUNCS``.

    Under ``"align"`` with ``roi_size = 7*s`` and s > 1 the caffe-convention
    res5 reads only every s-th pooled cell (its stride sits on 1x1 convs),
    so only those bins are pooled (``bin_stride=s``) and res5 runs at stride
    1: identical values for 1/s^2 of the pooling work
    (mask_rcnn_tpu/models/heads.py:67-86). ``"resize"`` and ``"pooling"``
    take the rois flat with their image indices, pool ``roi_size`` bins and
    run res5 at stride s (heads.py:88-114); ``sampling_ratio`` is RoIAlign's
    alone.

    ``mask_subset``: optional (M,) flat row indices of the rois to run the
    mask branch on (training: only positive samples carry mask targets).

    Returns dict with any of cls_locs (N*R, n_class*4), scores
    (N*R, n_class), masks (N*R or M, 14, 14, n_fg_class) logits.
    """
    s5 = roi_size // 7
    if pooling == "align":
        size, bin_stride = (7, s5) if s5 > 1 else (roi_size, 1)
        pool = roi_align_grouped(features, rois, size, spatial_scale,
                                 sampling_ratio, bin_stride)
        h = res5_forward(params["res5"],
                         pool.reshape(-1, size, size, features.shape[-1]),
                         stride=1)
    else:
        n, r = rois.shape[:2]
        # jnp.repeat(arange(n), r): each roi's image index
        roi_indices = torch.arange(n * r, dtype=torch.int32,
                                   device=rois.device) // r
        pool = POOLING_FUNCS[pooling](features, rois.reshape(n * r, 4),
                                      roi_indices, roi_size, spatial_scale)
        h = res5_forward(params["res5"], pool, stride=s5)

    out = {}
    if pred_bbox:
        p5 = h.mean(dim=(1, 2))  # == 7x7 average pooling
        out["cls_locs"] = p5 @ params["cls_loc"]["W"] + params["cls_loc"]["b"]
        out["scores"] = p5 @ params["score"]["W"] + params["score"]["b"]
    if pred_mask:
        hm = h if mask_subset is None else h.index_select(0, mask_subset)
        d = torch.relu(
            deconv2x2_s2(hm, params["deconv6"]["W"], params["deconv6"]["b"])
        )
        out["masks"] = conv2d(d, params["mask"]["W"]) + params["mask"]["b"]
    return out


def init_head(gen, n_class, n_layers=50, loc_std=0.001, std=0.01,
              initializer="normal"):
    """Reference initializers (mask_rcnn_tpu/models/heads.py:139-180):
    Normal(0.001) for cls_loc, Normal(0.01) for score, and for the mask
    branch (deconv6 + mask) the ``--initializer`` choice: 'normal' ->
    Normal(0.01), 'he_normal' -> HeNormal(fan_out) in chainer's fan
    convention (fan_out = W.shape[0] * prod(kernel) in chainer layout)."""
    n_fg = n_class - 1
    if initializer == "he_normal":
        # chainer layouts: deconv6 W (2048, 256, 2, 2), mask W (n_fg, 256,
        # 1, 1) -> fans 2048*4 and n_fg*1.
        deconv_std = (2.0 / (2048 * 2 * 2)) ** 0.5
        mask_std = (2.0 / n_fg) ** 0.5
    elif initializer == "normal":
        deconv_std = mask_std = std
    else:
        raise ValueError(f"unsupported initializer: {initializer}")
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
            "W": torch.randn((2048, 256, 2, 2), generator=gen) * deconv_std,
            "b": torch.zeros(256),
        },
        "mask": {
            "W": torch.randn((n_fg, 256, 1, 1), generator=gen) * mask_std,
            "b": torch.zeros(n_fg),
        },
    }
