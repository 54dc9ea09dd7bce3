"""Box geometry on torch tensors, the port of ``mask_rcnn_tpu/ops/boxes.py``.

Boxes are ``(y1, x1, y2, x2)`` float32, locs are ``(dy, dx, dh, dw)``
(y-first); no +1 offsets.
"""

from __future__ import annotations

import torch


def bbox_area(bbox: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) boxes; negative extents clamp to zero."""
    h = torch.clamp(bbox[..., 2] - bbox[..., 0], min=0.0)
    w = torch.clamp(bbox[..., 3] - bbox[..., 1], min=0.0)
    return h * w


def loc2bbox(src_bbox: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Decode (dy, dx, dh, dw) locs on top of src boxes -> (y1, x1, y2, x2)."""
    src_height = src_bbox[..., 2] - src_bbox[..., 0]
    src_width = src_bbox[..., 3] - src_bbox[..., 1]
    src_ctr_y = src_bbox[..., 0] + 0.5 * src_height
    src_ctr_x = src_bbox[..., 1] + 0.5 * src_width

    ctr_y = loc[..., 0] * src_height + src_ctr_y
    ctr_x = loc[..., 1] * src_width + src_ctr_x
    h = torch.exp(loc[..., 2]) * src_height
    w = torch.exp(loc[..., 3]) * src_width

    return torch.stack(
        [ctr_y - 0.5 * h, ctr_x - 0.5 * w, ctr_y + 0.5 * h, ctr_x + 0.5 * w],
        dim=-1,
    )


def clip_boxes(bbox: torch.Tensor, size) -> torch.Tensor:
    """Clip (..., 4) boxes to an image of (H, W).

    ``size`` is a pair of numbers, or a pair of tensors broadcastable
    against ``bbox[..., 0]`` (per-image sizes).
    """
    h, w = size

    def clip(x, hi):
        # two clamps: the tensor overload of clamp takes no scalar bound
        return torch.clamp(torch.clamp(x, min=0.0), max=hi)

    return torch.stack(
        [
            clip(bbox[..., 0], h),
            clip(bbox[..., 1], w),
            clip(bbox[..., 2], h),
            clip(bbox[..., 3], w),
        ],
        dim=-1,
    )
