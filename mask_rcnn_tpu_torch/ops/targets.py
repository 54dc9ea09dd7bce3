"""The device-side halves of the training target creators: the wrappers of
kernels K8 and K9 (``csrc/targets.cu``) and their plain torch versions.

* :func:`mask_crop_resize` (K8): the cv2-parity bilinear crop-resize of
  (bit-packed) gt masks to the sampled rois,
  ``mask_rcnn_tpu/models/targets.py::_crop_resize_masks_indexed`` with
  ``_mask_sample_coords``, batched over images;
* :func:`anchor_match` and :func:`proposal_match` (K9): each box's IoU
  match to the gt boxes and the label rules before sampling, the first
  halves of ``anchor_targets`` and ``proposal_targets``.

A CPU tensor takes the plain version, a CUDA tensor the kernel (or a
``ValueError`` for what the kernel does not take). The plain versions
follow the JAX package op for op, and the kernels repeat their arithmetic
bit for bit: the rules downstream (IoU thresholds, ``iou == gt_max``,
``interp > 0.5``) are discontinuous.
"""

from __future__ import annotations

import torch

from mask_rcnn_tpu_torch.ops import _kernels
from mask_rcnn_tpu_torch.ops.boxes import bbox_iou

# csrc/targets.cu::kMaxG: a block keeps its image's gt boxes in shared
# memory.
MAX_GT = 256


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


def _check_gt(bbox, bbox_valid, n, device):
    if bbox.dim() != 3 or bbox.shape[0] != n or bbox.shape[2] != 4:
        raise ValueError(f"gt boxes must be (N, G, 4), got "
                         f"{tuple(bbox.shape)}")
    g = bbox.shape[1]
    if not 1 <= g <= MAX_GT:
        raise ValueError(f"the kernel takes 1 <= G <= {MAX_GT} gt boxes")
    _check_cuda(bbox, "gt boxes", torch.float32, (n, g, 4), device)
    _check_cuda(bbox_valid, "gt validity", torch.bool, (n, g), device)
    return g


# --------------------------------------------------------------------------
# K9: matching


def _inside(anchors, img_size):
    h, w = img_size
    return ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
            & (anchors[:, 2] <= h) & (anchors[:, 3] <= w))


def anchor_match_plain(anchors, bbox, bbox_valid, img_size, pos_thresh,
                       neg_thresh):
    """Plain K9, anchor side (mask_rcnn_tpu/models/targets.py:76-101).

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
    """K9 wrapper, anchor side; see :func:`anchor_match_plain`."""
    if anchors.device.type == "cpu":
        return anchor_match_plain(anchors, bbox, bbox_valid, img_size,
                                  pos_thresh, neg_thresh)
    if anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError("anchors must be (S, 4)")
    s = anchors.shape[0]
    _check_cuda(anchors, "anchors", torch.float32, (s, 4), None)
    n = bbox.shape[0]
    g = _check_gt(bbox, bbox_valid, n, anchors.device)
    gt_max = torch.empty((n, g), dtype=torch.int32, device=anchors.device)
    argmax = torch.empty((n, s), dtype=torch.int64, device=anchors.device)
    label = torch.empty((n, s), dtype=torch.int32, device=anchors.device)
    h, w = img_size
    err = _kernels.lib().mrcnn_anchor_match(
        anchors.data_ptr(), bbox.data_ptr(), bbox_valid.data_ptr(),
        gt_max.data_ptr(), n, s, g, float(h), float(w), float(pos_thresh),
        float(neg_thresh), argmax.data_ptr(), label.data_ptr(),
        _kernels.stream_ptr(anchors.device),
    )
    _kernels.check(err, "mrcnn_anchor_match")
    anchor_match.launches += 1
    return argmax, label


anchor_match.launches = 0


def proposal_match_plain(cand, cand_valid, bbox, bbox_valid, pos_thresh,
                         neg_thresh_hi, neg_thresh_lo):
    """Plain K9, proposal side (mask_rcnn_tpu/models/targets.py:276-298).

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
    """K9 wrapper, proposal side; see :func:`proposal_match_plain`."""
    if cand.device.type == "cpu":
        return proposal_match_plain(cand, cand_valid, bbox, bbox_valid,
                                    pos_thresh, neg_thresh_hi, neg_thresh_lo)
    if cand.dim() != 3 or cand.shape[2] != 4:
        raise ValueError("candidates must be (N, P, 4)")
    n, p = cand.shape[:2]
    _check_cuda(cand, "candidates", torch.float32, (n, p, 4), None)
    _check_cuda(cand_valid, "candidate validity", torch.bool, (n, p),
                cand.device)
    g = _check_gt(bbox, bbox_valid, n, cand.device)
    argmax = torch.empty((n, p), dtype=torch.int64, device=cand.device)
    pos = torch.empty((n, p), dtype=torch.bool, device=cand.device)
    neg = torch.empty((n, p), dtype=torch.bool, device=cand.device)
    err = _kernels.lib().mrcnn_proposal_match(
        cand.data_ptr(), cand_valid.data_ptr(), bbox.data_ptr(),
        bbox_valid.data_ptr(), n, p, g, float(pos_thresh),
        float(neg_thresh_hi), float(neg_thresh_lo), argmax.data_ptr(),
        pos.data_ptr(), neg.data_ptr(), _kernels.stream_ptr(cand.device),
    )
    _kernels.check(err, "mrcnn_proposal_match")
    proposal_match.launches += 1
    return argmax, pos, neg


proposal_match.launches = 0


# --------------------------------------------------------------------------
# K8: mask-target crop-resize


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
    """Plain K8 (mask_rcnn_tpu/models/targets.py:190-238), batched.

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
    """K8 wrapper; see :func:`mask_crop_resize_plain`. On the GPU the masks
    must be a contiguous uint8 (or bool, unpacked) tensor, gt_index int64
    and rois float32, all contiguous on one device."""
    if masks.device.type == "cpu":
        return mask_crop_resize_plain(masks, gt_index, rois, out_size,
                                      packed)
    if masks.dim() != 4:
        raise ValueError("masks must be (N, G, H, W) or (N, G, H, W/8)")
    if masks.dtype == torch.bool and not packed:
        masks = masks.view(torch.uint8)
    n, g, h, wm = masks.shape
    _check_cuda(masks, "masks", torch.uint8, (n, g, h, wm), None)
    if rois.dim() != 3:
        raise ValueError("rois must be (N, Q, 4)")
    q = rois.shape[1]
    _check_cuda(rois, "rois", torch.float32, (n, q, 4), masks.device)
    _check_cuda(gt_index, "gt_index", torch.int64, (n, q), masks.device)
    if out_size < 1:
        raise ValueError("out_size must be >= 1")
    out = torch.empty((n, q, out_size, out_size), dtype=torch.int32,
                      device=masks.device)
    err = _kernels.lib().mrcnn_mask_crop_resize(
        masks.data_ptr(), gt_index.data_ptr(), rois.data_ptr(), n, g, h, wm,
        q, out_size, int(bool(packed)), out.data_ptr(),
        _kernels.stream_ptr(masks.device),
    )
    _kernels.check(err, "mrcnn_mask_crop_resize")
    mask_crop_resize.launches += 1
    return out


mask_crop_resize.launches = 0
