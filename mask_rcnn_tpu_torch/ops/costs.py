"""What the hand kernels do, and what the card can do: the one home of the
work formulas and the peak table that ``utils/profiling.py::cost_of``, the
profiling tools (``examples/{mfu_report,train_profile,head_profile,
bench_align_variants}.py``) and ``chip_smoke.py`` read.

The kernels are loaded through ``ctypes`` (``ops/_kernels.py``), not
registered as torch ops, so no torch cost counter sees their work. Each
kernel wrapper therefore reports it: the :func:`kernel` decorator hands the
wrapper's tensors and the kernel's formula of this module
(``<kernel>_cost``) to the counter that ``cost_of`` installs in
:data:`ACTIVE`. With no counter active the report is one ``None`` check (no
formula runs, no host synchronisation). On CPU tensors a wrapper runs its
kernel's plain version through :func:`uncounted`, so a count on the CPU
holds the kernel's work, not the plain version's einsums and sorts.

Conventions (those of ``chip_smoke.py``'s kernel bounds): bytes are each
input read once and each output written once; FLOPs are the arithmetic the
kernel does on this data: 8 a bilinear sample and channel (four taps, a
multiply-add each), 12 an IoU pair that a greedy NMS scan evaluates, one a
compare of a max pooling, and 2 a multiply-accumulate of the stem's 7x7
conv over every tap, padded ones included, as ``FlopCounterMode`` counts
the four-op stem's conv.
"""

from __future__ import annotations

import functools

import numpy as np

# The NVIDIA H100 SXM (80 GB HBM3): 3.35 TB/s of memory; dense peaks of
# 989 TFLOP/s bf16 on the tensor cores and 67 TFLOP/s float32 on the CUDA
# cores (the port runs float32 without TF32, ``set_float32_precision``).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Card name (``torch.cuda.get_device_name``) -> its peaks. A card that is
# not here has no peaks: its MFU and roofline floors are nan.
CARDS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": HBM_BYTES_PER_S,
                              "flops": PEAK_FLOPS},
}


def roofline(flops, n_bytes, peaks, kind="bf16"):
    """(floor ms, "mem" or "flop"): the least time a card of ``peaks`` takes
    to move ``n_bytes`` and do ``flops`` at its ``kind`` peak, whichever is
    longer; (nan, "?") without peaks."""
    if peaks is None:
        return float("nan"), "?"
    t_mem = n_bytes / peaks["bytes_per_s"]
    t_ops = flops / peaks["flops"][kind]
    return max(t_mem, t_ops) * 1e3, "mem" if t_mem >= t_ops else "flop"


def nbytes(*tensors):
    """Bytes of the tensors: each input read once, each output written
    once."""
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# The counter hook

# The counter of ``utils/profiling.py::cost_of`` while one runs, else None.
# It has ``add_kernel(name, cost, args)`` and a ``paused()`` context.
ACTIVE = None


def uncounted(fn, *args):
    """``fn(*args)``, a plain version standing in for its kernel, kept out
    of the active counter (the kernel's report counts the work)."""
    if ACTIVE is None:
        return fn(*args)
    with ACTIVE.paused():
        return fn(*args)


def kernel(name, plain, device_arg=0):
    """Decorates the function that launches kernel ``name``: on CPU tensors
    (argument ``device_arg`` on the CPU) the wrapper runs ``plain``
    instead, kept out of the active counter, and either way it then reports
    the launch's work, ``<name>_cost(out, *args)`` of this module, to the
    active counter. Arguments are positional. With no counter active the
    report is one ``None`` check."""

    def wrap(launch):
        @functools.wraps(launch)
        def wrapper(*args):
            if args[device_arg].device.type == "cpu":
                out = uncounted(plain, *args)
            else:
                out = launch(*args)
            if ACTIVE is not None:
                ACTIVE.add_kernel(name, globals()[name + "_cost"],
                                  (out, *args))
            return out
        return wrapper

    return wrap


# ---------------------------------------------------------------------------
# The formulas: (flops, bytes) of one launch, from its tensors


def align_samples(rois, feat_hw, p=7, s=2, scale=1 / 16, sampling_ratio=0):
    """RoIAlign's bilinear samples for these rois: the sum over rois of
    P*P*gy*gx, with Detectron's adaptive grid (``sampling_ratio`` 0) or a
    fixed one, on a virtual grid of P*s bins (``bin_stride`` s)."""
    r = np.asarray(rois, np.float32).reshape(-1, 4) * np.float32(scale)
    if sampling_ratio > 0:
        return float(len(r)) * sampling_ratio ** 2 * p * p
    full = p * s
    ext = np.maximum(r[:, 2:] - r[:, :2], 1.0)
    gy = np.clip(np.ceil(ext[:, 0] / full), 1, -(-feat_hw[0] // full))
    gx = np.clip(np.ceil(ext[:, 1] / full), 1, -(-feat_hw[1] // full))
    return float((gy * gx).sum()) * p * p


def _align_cost(features, rois, roi_indices, pooled, spatial_scale,
                sampling_ratio, bin_stride):
    """RoIAlign forward (``features`` in, ``pooled`` out) and backward (the
    pooled gradient in, the features' gradient out): the same taps either
    way. ``roi_indices`` is None for grouped rois."""
    c = features.shape[-1]
    samples = align_samples(rois.detach().cpu().numpy(),
                            tuple(features.shape[1:3]), pooled.shape[-2],
                            bin_stride, spatial_scale, sampling_ratio)
    extra = () if roi_indices is None else (roi_indices,)
    return 8 * c * samples, nbytes(features, rois, *extra, pooled)


def roi_align_grouped_cost(out, features, rois, out_size, spatial_scale,
                           sampling_ratio, bin_stride):
    """K1."""
    return _align_cost(features, rois, None, out, spatial_scale,
                       sampling_ratio, bin_stride)


def roi_align_grouped_backward_cost(grad, grad_out, rois, feat_hw,
                                    spatial_scale, sampling_ratio=0,
                                    bin_stride=1):
    """K7."""
    return _align_cost(grad, rois, None, grad_out, spatial_scale,
                       sampling_ratio, bin_stride)


def roi_align_cost(out, features, rois, roi_indices, out_size,
                   spatial_scale, sampling_ratio, bin_stride):
    """K4."""
    return _align_cost(features, rois, roi_indices, out, spatial_scale,
                       sampling_ratio, bin_stride)


def roi_align_backward_cost(grad, grad_out, rois, roi_indices, feat_shape,
                            spatial_scale, sampling_ratio=0, bin_stride=1):
    """K13."""
    return _align_cost(grad, rois, roi_indices, grad_out, spatial_scale,
                       sampling_ratio, bin_stride)


def crop_and_resize_cost(out, features, rois, roi_indices, out_size,
                         spatial_scale):
    """K5: four bilinear taps a pooled value."""
    return 8 * out.numel(), nbytes(features, rois, roi_indices, out)


def crop_and_resize_backward_cost(grad, grad_out, rois, roi_indices,
                                  feat_shape, spatial_scale):
    """K11: the forward's taps, from the pooled gradient."""
    return (8 * grad_out.numel(),
            nbytes(grad_out, rois, roi_indices, grad))


def pool_reads(rois, p, scale, hw):
    """Feature positions that max RoI pooling reads for these flat rois:
    the sum of its bins' areas (chainer's quantized bins)."""
    from mask_rcnn_tpu_torch.ops.roi_align import _pool_bounds

    r = rois.float()
    ys, ye = _pool_bounds(r[:, 0], r[:, 2], hw[0], p, scale)
    xs, xe = _pool_bounds(r[:, 1], r[:, 3], hw[1], p, scale)
    return float(((ye - ys)[:, :, None] * (xe - xs)[:, None, :]).sum())


def roi_pool_cost(out, features, rois, roi_indices, out_size,
                  spatial_scale):
    """K6: a compare a value read."""
    n, h, w, c = features.shape
    reads = c * pool_reads(rois, out_size, spatial_scale, (h, w))
    return reads, nbytes(features, rois, roi_indices, out)


def roi_pool_backward_cost(grad, grad_out, features, rois, roi_indices,
                           spatial_scale):
    """K12: the forward's compares again and an add a winning position."""
    n, h, w, c = features.shape
    reads = c * pool_reads(rois, grad_out.shape[1], spatial_scale, (h, w))
    return 2 * reads, nbytes(grad_out, features, rois, roi_indices, grad)


def nms_stops(idx, mask, n, max_out):
    """Per problem, the candidates that a greedy scan reads: up to the last
    kept box once ``max_out`` survive, else all ``n``."""
    stops = []
    for row_idx, row_mask in zip(idx.cpu().numpy(), mask.cpu().numpy()):
        kept = row_idx[row_mask]
        full = max_out and len(kept) >= max_out
        stops.append(int(kept.max()) + 1 if full else n)
    return stops


def nms_pairs(idx, mask, n, max_out):
    """IoU pairs a greedy NMS needs on this data: each kept box against the
    candidates after it, up to the row where the scan stopped."""
    pairs = 0
    for row_idx, row_mask, stop in zip(idx.cpu().numpy(), mask.cpu().numpy(),
                                       nms_stops(idx, mask, n, max_out)):
        kept = row_idx[row_mask]
        pairs += int((stop - kept - 1).clip(min=0).sum())
    return pairs


def nms_blocked_cost(out, boxes, valid, thresh, max_out):
    """K2 and the standalone K3: 12 operations an IoU pair."""
    idx, mask = out
    return (12 * nms_pairs(idx, mask, valid.shape[1], max_out),
            nbytes(boxes, valid, idx, mask))


nms_small_cost = nms_blocked_cost


def decode_pairs(cls_bbox, prob, valid, thresh, k, nms_thresh, d):
    """(IoU pairs, selected rows) of the decode's selection on this data:
    per (image, class) the valid rows above ``thresh`` (at most ``k``),
    each kept box against the selected candidates after it, up to where
    the class's scan stops; from the plain selection's own steps."""
    import torch

    from mask_rcnn_tpu_torch.ops import nms
    from mask_rcnn_tpu_torch.ops.tensors import gather_rows, top_k_stable

    n, rp, c = prob.shape
    fg_p = prob[:, :, 1:].transpose(1, 2).reshape(-1, rp)
    fg_b = cls_bbox[:, :, 1:].transpose(1, 2).reshape(-1, rp, 4)
    ok = valid[:, None, :].expand(n, c - 1, rp).reshape(-1, rp) & (
        fg_p > thresh)
    top_p, top_i = top_k_stable(torch.where(ok, fg_p, -torch.inf),
                                k if 0 < k < rp else rp)
    sel = torch.isfinite(top_p)
    plain = (nms.nms_small_plain if sel.shape[1] <= nms.SMALL_MAX_N
             else nms.nms_blocked_plain)
    idx, mask = plain(gather_rows(fg_b, top_i), sel, nms_thresh, d)
    pairs = 0
    for row_idx, row_mask, cnt in zip(idx.cpu().numpy(), mask.cpu().numpy(),
                                      sel.sum(1).tolist()):
        kept = row_idx[row_mask]
        stop = kept.max() + 1 if len(kept) >= d else cnt
        pairs += int((stop - kept - 1).clip(min=0).sum())
    return pairs, int(sel.sum())


def decode_select_cost(out, cls_bbox, prob, roi_valid, score_thresh,
                       topk_per_class, nms_thresh, d):
    """K3 on the serving path (``decode_select``): its IoU pairs."""
    pairs, _ = decode_pairs(cls_bbox, prob, roi_valid, score_thresh,
                            topk_per_class, nms_thresh, d)
    return 12 * pairs, nbytes(cls_bbox, prob, roi_valid, *out)


def anchor_targets_cost(out, bbox, bbox_valid, anchors, img_size, pri_pos,
                        pri_neg, cfg):
    """K9a: an IoU (12 operations) per (anchor, valid gt) pair."""
    n_gt = int(bbox_valid.sum())
    return (12 * anchors.shape[0] * n_gt,
            nbytes(bbox, bbox_valid, anchors, pri_pos, pri_neg, *out))


def proposal_targets_cost(out, roi, roi_valid, bbox, label, bbox_valid,
                          mask, pri_pos, pri_neg, cfg, *normalize):
    """K9b + K8: an IoU per (candidate, valid gt) pair of an image, and a
    bilinear sample (8 operations) per mask cell of a positive slot.
    ``out`` = (sample_roi, gt_loc, gt_label, gt_mask)."""
    cand = roi.shape[1] + bbox.shape[1]
    positives = int((out[2] > 0).sum())
    return (12 * cand * int(bbox_valid.sum())
            + 8 * positives * cfg.mask_size * cfg.mask_size,
            nbytes(roi, roi_valid, bbox, label, bbox_valid, mask, pri_pos,
                   pri_neg, *out))


def stem_forward_cost(out, params, x):
    """K10: 2 a multiply-accumulate of conv1 (7x7/2, 3 -> 64, pad 3) over
    its padded taps; it reads conv1 and bn1."""
    n, h, w, _ = x.shape
    macs = n * -(-h // 2) * -(-w // 2) * 64 * 3 * 7 * 7
    return 2 * macs, nbytes(x, params["conv1"]["W"], params["bn1"]["scale"],
                            params["bn1"]["bias"], out)
