"""Exact greedy NMS over padded, batched boxes, the port of
``mask_rcnn_tpu/ops/nms.py``.

Greedy NMS keeps box j (in descending-score order) iff it is valid and no
kept box i < j has ``IoU(i, j) > thresh``. Two paths, each a wrapper over a
plain torch version (CPU tensors) and a hand-written kernel (CUDA tensors,
``csrc/nms.cu``):

* :func:`nms_small` (K3) for N <= :data:`SMALL_MAX_N` boxes per problem:
  the fixpoint formulation of ``nms_fixpoint_mask`` plus compaction;
* :func:`nms_blocked` (K2) for larger N: the blocked formulation of
  ``nms_blocked_mask``, which stops at ``max_out`` survivors.

On the card both are one launch of the same scan, tiles of 64 candidates
against the kept set (K2 with 1024 threads a problem, K3 with 256). Both
return the first ``max_out`` survivors of the exact greedy answer, so the
choice between them changes no result.

:func:`decode_select` is K3 on the decode path: the selection half of the
detection decode (per-class top-k, per-class NMS, the rounded-zero-area
drop and the final top ``d``), one launch for a batch on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mask_rcnn_tpu_torch.ops import _kernels, costs
from mask_rcnn_tpu_torch.ops.tensors import gather_rows, top_k_stable

# The standalone K3 takes at most this many boxes a problem and keeps its
# whole kept set in shared memory (csrc/nms.cu::kSmallMaxN).
SMALL_MAX_N = 1024
_PLAIN_BLOCK = 1024


def _pair_suppression(a, b, thresh):
    """(..., I, J) bool ``IoU(a_i, b_j) > thresh``, division-free:
    ``inter > t * (area_a + area_b - inter)``
    (mask_rcnn_tpu/ops/nms.py:27-45)."""
    ay1, ax1, ay2, ax2 = (a[..., k, None] for k in range(4))
    by1, bx1, by2, bx2 = (b[..., None, :, k] for k in range(4))
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    inter = ih * iw
    area_a = torch.clamp(ay2 - ay1, min=0.0) * torch.clamp(ax2 - ax1, min=0.0)
    area_b = torch.clamp(by2 - by1, min=0.0) * torch.clamp(bx2 - bx1, min=0.0)
    return inter > thresh * (area_a + area_b - inter)


def nms_fixpoint_mask(boxes, valid, thresh):
    """(B, N) keep mask of exact greedy NMS on sorted boxes (B, N, 4), as
    the fixpoint of ``k[j] = valid[j] and not any_i(k[i] and S[i, j])``."""
    n = boxes.shape[-2]
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (_pair_suppression(boxes, boxes, thresh) & upper
           & valid[..., :, None] & valid[..., None, :])
    kept = valid
    for _ in range(n):
        new = valid & ~(sup & kept[..., :, None]).any(dim=-2)
        if torch.equal(new, kept):
            break
        kept = new
    return kept


def nms_small_plain(boxes, valid, thresh, max_out):
    """Plain K3: fixpoint keep mask, then the first ``max_out`` kept
    positions in score order, -1 padded, with their validity."""
    kept = nms_fixpoint_mask(boxes, valid, thresh)
    pos = torch.sort((~kept).to(torch.uint8), dim=-1, stable=True).indices
    pos = pos[..., :max_out]
    mask = torch.gather(kept, -1, pos)
    idx = torch.where(mask, pos, -1).to(torch.int32)
    short = max_out - idx.shape[-1]
    if short > 0:  # fewer inputs than requested outputs
        idx = torch.nn.functional.pad(idx, (0, short), value=-1)
        mask = torch.nn.functional.pad(mask, (0, short), value=False)
    return idx, mask


def nms_blocked_plain(boxes, valid, thresh, max_out, block=_PLAIN_BLOCK):
    """Plain K2, per problem: score-order blocks are tested against the
    compact kept set, resolved inside by the fixpoint, until ``max_out``
    survivors exist (mask_rcnn_tpu/ops/nms.py:113-174)."""
    b, n = valid.shape
    idx = torch.full((b, max_out), -1, dtype=torch.int32,
                     device=boxes.device)
    for i in range(b):
        kept_boxes = boxes.new_zeros((0, 4))
        kept_pos = []
        for start in range(0, n, block):
            if len(kept_pos) >= max_out:
                break
            blk = boxes[i, start:start + block]
            bval = valid[i, start:start + block]
            if len(kept_pos):
                bval = bval & ~_pair_suppression(kept_boxes, blk,
                                                 thresh).any(dim=0)
            keep = nms_fixpoint_mask(blk[None], bval[None], thresh)[0]
            new = torch.nonzero(keep).flatten()[: max_out - len(kept_pos)]
            kept_boxes = torch.cat([kept_boxes, blk[new]])
            kept_pos.extend((new + start).tolist())
        idx[i, : len(kept_pos)] = torch.tensor(kept_pos, dtype=torch.int32)
    return idx, idx >= 0


def _checked_outputs(boxes, valid, max_out):
    """Raise on what the NMS kernels do not take; allocate their outputs."""
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if (boxes.dim() != 3 or boxes.shape[-1] != 4
            or boxes.dtype != torch.float32 or not boxes.is_contiguous()
            or boxes.data_ptr() % 16):
        raise ValueError("boxes must be a contiguous, 16-byte aligned "
                         "float32 (B, N, 4) tensor")
    if (valid.shape != boxes.shape[:2] or valid.dtype != torch.bool
            or not valid.is_contiguous() or valid.device != boxes.device):
        raise ValueError("valid must be a contiguous bool (B, N) tensor on "
                         "the boxes' device")
    if max_out < 0:
        raise ValueError("max_out must be >= 0")
    b = boxes.shape[0]
    idx = torch.empty((b, max_out), dtype=torch.int32, device=boxes.device)
    mask = torch.empty((b, max_out), dtype=torch.bool, device=boxes.device)
    return idx, mask


@costs.kernel("nms_blocked", nms_blocked_plain)
def nms_blocked(boxes, valid, thresh, max_out):
    """K2 wrapper: boxes (B, N, 4) sorted by descending score, valid (B, N)
    -> positions (B, max_out) int32 into the sorted order, -1 padded, and
    their validity (B, max_out) bool. The kernel keeps up to
    :func:`nms_kept_cap` kept boxes in shared memory; past that the rest go
    to a (B, max_out - cap, 4) float32 scratch allocated here."""
    idx, mask = _checked_outputs(boxes, valid, max_out)
    b, n = valid.shape
    spill, cap = None, nms_kept_cap()
    if max_out > cap:
        spill = torch.empty((b, max_out - cap, 4), dtype=torch.float32,
                            device=boxes.device)
    err = _kernels.lib().mrcnn_nms_blocked(
        boxes.data_ptr(), valid.data_ptr(),
        None if spill is None else spill.data_ptr(), b, n, float(thresh),
        max_out, idx.data_ptr(), mask.data_ptr(),
        _kernels.stream_ptr(boxes.device),
    )
    _kernels.check(err, "mrcnn_nms_blocked")
    nms_blocked.launches += 1
    return idx, mask


nms_blocked.launches = 0


def nms_kept_cap():
    """Kept boxes that K2 holds in shared memory (``csrc/nms.cu``)."""
    return _kernels.lib().mrcnn_nms_kept_cap()


@costs.kernel("nms_small", nms_small_plain)
def nms_small(boxes, valid, thresh, max_out):
    """K3 wrapper: as :func:`nms_blocked`, for N <= :data:`SMALL_MAX_N`."""
    idx, mask = _checked_outputs(boxes, valid, max_out)
    b, n = valid.shape
    if n > SMALL_MAX_N:
        raise ValueError(f"nms_small takes N <= {SMALL_MAX_N}, got {n}")
    err = _kernels.lib().mrcnn_nms_small(
        boxes.data_ptr(), valid.data_ptr(), b, n, float(thresh), max_out,
        idx.data_ptr(), mask.data_ptr(), _kernels.stream_ptr(boxes.device),
    )
    _kernels.check(err, "mrcnn_nms_small")
    nms_small.launches += 1
    return idx, mask


nms_small.launches = 0


def nms_padded(bbox, score, thresh, max_out, valid=None, presorted=False):
    """Greedy NMS over padded, batched boxes.

    Args:
        bbox: (B, N, 4) boxes (y1, x1, y2, x2).
        score: (B, N) scores.
        thresh: suppress j when IoU(i, j) > thresh.
        max_out: number of survivors to return (padded).
        valid: optional (B, N) bool mask of real rows.
        presorted: rows are already in descending-score order (straight out
            of a descending sort) -- skips the sort.

    Returns:
        indices: (B, max_out) int32 indices into the input, score-ordered,
            -1 padded.
        mask: (B, max_out) bool validity of each returned slot.
    """
    b, n = score.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=score.device)
    if presorted:
        bbox_sorted, valid_sorted = bbox, valid
    else:
        # stable: ties keep input order, like jnp.argsort(descending=True)
        order = torch.sort(
            torch.where(valid, score, -torch.inf), dim=-1, descending=True,
            stable=True,
        ).indices
        bbox_sorted = torch.gather(bbox, 1, order[..., None].expand(-1, -1, 4))
        valid_sorted = torch.gather(valid, 1, order)
    bbox_sorted = bbox_sorted.to(torch.float32).contiguous()
    valid_sorted = valid_sorted.contiguous()
    run = nms_small if n <= SMALL_MAX_N else nms_blocked
    pos, mask = run(bbox_sorted, valid_sorted, thresh, max_out)
    if not presorted:
        pos = torch.where(
            mask, torch.gather(order, 1, pos.clamp(min=0).long()), -1
        ).to(torch.int32)
    return pos, mask


def decode_select_plain(cls_bbox, prob, roi_valid, score_thresh,
                        topk_per_class, nms_thresh, d):
    """Plain decode selection (mask_rcnn_tpu/models/mask_rcnn.py:170-219):
    per foreground class the ``topk_per_class`` most probable rows (all
    when 0 or >= Rp) that are valid and above ``score_thresh``, greedy NMS
    at ``nms_thresh`` down to ``d``, the drop of boxes whose rounded (half
    to even) area is not positive, then the top ``d`` of the image.

    Args: cls_bbox (N, Rp, C, 4) float32 decoded boxes, prob (N, Rp, C)
    float32 class probabilities (class 0 the background, skipped),
    roi_valid (N, Rp) bool.

    Returns (boxes (N, d, 4), labels (N, d) int32 0-based, -1 pad,
    scores (N, d), valid (N, d)).
    """
    n, rp, n_class = prob.shape
    n_fg = n_class - 1
    dev = prob.device

    # classes 1..n_class-1, one problem per (image, class)
    fg_boxes = cls_bbox[:, :, 1:].transpose(1, 2).reshape(n * n_fg, rp, 4)
    fg_probs = prob[:, :, 1:].transpose(1, 2).reshape(n * n_fg, rp)
    valid_l = (roi_valid[:, None, :].expand(n, n_fg, rp).reshape(n * n_fg, rp)
               & (fg_probs > score_thresh))
    k = topk_per_class
    if k and k < rp:
        top_p, top_i = top_k_stable(
            torch.where(valid_l, fg_probs, -torch.inf), k
        )
        top_b = gather_rows(fg_boxes, top_i)
        idx, mask = nms_padded(top_b, top_p, nms_thresh, d,
                               valid=torch.isfinite(top_p), presorted=True)
        sel = idx.clamp(min=0).long()
        b = gather_rows(top_b, sel)
        s = torch.where(mask, torch.gather(top_p, 1, sel), 0.0)
    else:
        idx, mask = nms_padded(fg_boxes, fg_probs, nms_thresh, d,
                               valid=valid_l)
        sel = idx.clamp(min=0).long()
        b = gather_rows(fg_boxes, sel)
        s = torch.gather(fg_probs, 1, sel)

    b = b.reshape(n, n_fg * d, 4)
    s = s.reshape(n, n_fg * d)
    m = mask.reshape(n, n_fg * d)
    labels = torch.arange(n_fg, dtype=torch.int32, device=dev)
    labels = labels[:, None].expand(n_fg, d).reshape(-1)

    # Drop boxes whose rounded (half to even) integer area is zero.
    bi = torch.round(b)
    area = (bi[..., 2] - bi[..., 0]) * (bi[..., 3] - bi[..., 1])
    m = m & (area > 0)

    top_s, top_i = top_k_stable(torch.where(m, s, -torch.inf), d)
    out_valid = torch.isfinite(top_s)
    out_boxes = torch.where(out_valid[..., None], gather_rows(b, top_i), 0.0)
    out_labels = torch.where(out_valid, labels[top_i], -1)
    out_scores = torch.where(out_valid, top_s, 0.0)
    return out_boxes, out_labels, out_scores, out_valid


@functools.lru_cache(maxsize=None)
def decode_limits():
    """What the decode kernel takes (``csrc/nms.cu``): rows a class (Rp),
    ``n_fg * d`` candidates, foreground classes, and ``d``."""
    out = (ctypes.c_int * 4)()
    _kernels.check(_kernels.lib().mrcnn_decode_limits(out),
                   "mrcnn_decode_limits")
    return {"rows": out[0], "candidates": out[1], "classes": out[2],
            "d": out[3]}


# Per (device, stream): one uint32 counter an image for the decode kernel's
# last-block merge. Zero when allocated; each launch leaves it zero.
_TICKETS = {}


def _tickets(device, n):
    key = (device, _kernels.stream_ptr(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 8), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


@costs.kernel("decode_select", decode_select_plain, device_arg=1)
def decode_select(cls_bbox, prob, roi_valid, score_thresh, topk_per_class,
                  nms_thresh, d):
    """K3 wrapper, the decode's selection (see :func:`decode_select_plain`
    for the arguments and outputs). A CPU tensor takes the plain version; a
    CUDA tensor one launch of ``csrc/nms.cu::decode_select_kernel`` for the
    whole batch, whose outputs equal the plain version's on the card bit for
    bit. Raises on what the kernel does not take: contiguous float32 prob
    (N, Rp, C) and 16-byte aligned cls_bbox (N, Rp, C, 4), bool roi_valid
    (N, Rp), all on one device, within :func:`decode_limits`."""
    if prob.device.type != "cuda":
        raise ValueError(f"unsupported device {prob.device}")
    if (prob.dim() != 3 or prob.dtype != torch.float32
            or not prob.is_contiguous() or prob.shape[-1] < 2):
        raise ValueError("prob must be a contiguous float32 (N, Rp, C) "
                         f"tensor with C >= 2, got {tuple(prob.shape)} "
                         f"{prob.dtype}")
    n, rp, c = prob.shape
    if (cls_bbox.shape != (n, rp, c, 4) or cls_bbox.dtype != torch.float32
            or not cls_bbox.is_contiguous() or cls_bbox.data_ptr() % 16
            or cls_bbox.device != prob.device):
        raise ValueError("cls_bbox must be a contiguous, 16-byte aligned "
                         f"float32 {(n, rp, c, 4)} tensor on prob's device, "
                         f"got {tuple(cls_bbox.shape)} {cls_bbox.dtype}")
    if (roi_valid.shape != (n, rp) or roi_valid.dtype != torch.bool
            or not roi_valid.is_contiguous()
            or roi_valid.device != prob.device):
        raise ValueError(f"roi_valid must be a contiguous bool {(n, rp)} "
                         "tensor on prob's device")
    lim = decode_limits()
    if (rp > lim["rows"] or c - 1 > lim["classes"] or d > lim["d"]
            or (c - 1) * d > lim["candidates"] or d < 0):
        raise ValueError(
            f"decode_select takes Rp <= {lim['rows']}, at most "
            f"{lim['classes']} classes, 0 <= d <= {lim['d']} and n_fg * d <= "
            f"{lim['candidates']}; got Rp={rp}, n_fg={c - 1}, d={d}")
    dev = prob.device
    f32 = dict(dtype=torch.float32, device=dev)
    s_boxes = torch.empty((n, c - 1, d, 4), **f32)
    s_scores = torch.empty((n, c - 1, d), **f32)
    s_counts = torch.empty((n, c - 1), dtype=torch.int32, device=dev)
    boxes = torch.empty((n, d, 4), **f32)
    labels = torch.empty((n, d), dtype=torch.int32, device=dev)
    scores = torch.empty((n, d), **f32)
    valid = torch.empty((n, d), dtype=torch.bool, device=dev)
    err = _kernels.lib().mrcnn_decode_select(
        prob.data_ptr(), cls_bbox.data_ptr(), roi_valid.data_ptr(), n, rp, c,
        float(score_thresh), int(topk_per_class), float(nms_thresh), d,
        s_boxes.data_ptr(), s_scores.data_ptr(), s_counts.data_ptr(),
        _tickets(dev, n).data_ptr(), boxes.data_ptr(), labels.data_ptr(),
        scores.data_ptr(), valid.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "mrcnn_decode_select")
    decode_select.launches += 1
    return boxes, labels, scores, valid


decode_select.launches = 0
