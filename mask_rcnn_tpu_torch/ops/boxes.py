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


def bbox_iou(bbox_a: torch.Tensor, bbox_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., K, 4) boxes -> (..., N, K).

    The arithmetic of ``mask_rcnn_tpu/ops/boxes.py::bbox_iou`` in its order
    (each op rounded once, a true division): the target rules downstream
    compare IoU with 0.7, 0.3 and 0.5 and test ``iou == gt_max``, and the
    matching kernel (``csrc/targets.cu``) repeats it bit for bit.
    """
    tl = torch.maximum(bbox_a[..., :, None, :2], bbox_b[..., None, :, :2])
    br = torch.minimum(bbox_a[..., :, None, 2:], bbox_b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    area_i = wh[..., 0] * wh[..., 1]
    area_a = bbox_area(bbox_a)[..., :, None]
    area_b = bbox_area(bbox_b)[..., None, :]
    denom = area_a + area_b - area_i
    return torch.where(denom > 0, area_i / denom, 0.0)


def bbox2loc(src_bbox: torch.Tensor, dst_bbox: torch.Tensor) -> torch.Tensor:
    """Encode dst boxes relative to src boxes as (dy, dx, dh, dw), heights
    and widths clamped to float32 eps (chainercv ``bbox2loc``)."""
    height = src_bbox[..., 2] - src_bbox[..., 0]
    width = src_bbox[..., 3] - src_bbox[..., 1]
    ctr_y = src_bbox[..., 0] + 0.5 * height
    ctr_x = src_bbox[..., 1] + 0.5 * width

    base_height = dst_bbox[..., 2] - dst_bbox[..., 0]
    base_width = dst_bbox[..., 3] - dst_bbox[..., 1]
    base_ctr_y = dst_bbox[..., 0] + 0.5 * base_height
    base_ctr_x = dst_bbox[..., 1] + 0.5 * base_width

    eps = torch.finfo(torch.float32).eps
    height = torch.clamp(height, min=eps)
    width = torch.clamp(width, min=eps)

    dy = (base_ctr_y - ctr_y) / height
    dx = (base_ctr_x - ctr_x) / width
    dh = torch.log(torch.clamp(base_height, min=eps) / height)
    dw = torch.log(torch.clamp(base_width, min=eps) / width)
    return torch.stack([dy, dx, dh, dw], dim=-1)


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


def flip_boxes_horizontal(bbox: torch.Tensor, width) -> torch.Tensor:
    """Horizontally flip boxes within an image of the given pixel width."""
    return torch.stack([bbox[..., 0], width - bbox[..., 3], bbox[..., 2],
                        width - bbox[..., 1]], dim=-1)


def resize_boxes(bbox: torch.Tensor, scale_y, scale_x) -> torch.Tensor:
    """Rescale boxes by per-axis factors."""
    return bbox * torch.tensor([scale_y, scale_x, scale_y, scale_x],
                               dtype=bbox.dtype, device=bbox.device)
