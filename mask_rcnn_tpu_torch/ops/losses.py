"""Loss functions with chainer-parity semantics, the port of
``mask_rcnn_tpu/ops/losses.py``.

Label -1 is "ignore": an ignored entry contributes nothing, and each
normalizer is the count of non-ignored entries, clamped at 1.
"""

from __future__ import annotations

import torch


def smooth_l1_loss(x, t, in_weight, sigma):
    """Summed smooth-L1: quadratic below 1/sigma^2, linear above."""
    sigma2 = sigma**2
    diff = in_weight * (x - t)
    abs_diff = torch.abs(diff)
    flag = (abs_diff < (1.0 / sigma2)).to(x.dtype)
    y = flag * (sigma2 / 2.0) * torch.square(diff) + (1 - flag) * (
        abs_diff - 0.5 / sigma2
    )
    return torch.sum(y)


def fast_rcnn_loc_loss(pred_loc, gt_loc, gt_label, sigma):
    """Smooth-L1 over positive rows, normalized by #(label >= 0)."""
    in_weight = (gt_label > 0).to(pred_loc.dtype)[..., None]
    in_weight = in_weight.expand(gt_loc.shape)
    loss = smooth_l1_loss(pred_loc, gt_loc, in_weight, sigma)
    denom = torch.sum((gt_label >= 0).to(pred_loc.dtype))
    return loss / torch.clamp(denom, min=1.0)


def sigmoid_cross_entropy(logits, labels):
    """Mean sigmoid CE; ``labels`` in {-1, 0, 1}, -1 entries ignored."""
    valid = labels >= 0
    t = torch.clamp(labels, min=0).to(logits.dtype)
    # Numerically stable: max(x,0) - x*t + log1p(exp(-|x|))
    loss = (
        torch.clamp(logits, min=0.0)
        - logits * t
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    loss = torch.where(valid, loss, 0.0)
    denom = torch.sum(valid.to(logits.dtype))
    return torch.sum(loss) / torch.clamp(denom, min=1.0)


def softmax_cross_entropy(logits, labels):
    """Mean softmax CE over the last axis; label -1 ignored."""
    valid = labels >= 0
    safe_labels = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    loss = torch.where(valid, -picked, 0.0)
    denom = torch.sum(valid.to(logits.dtype))
    return torch.sum(loss) / torch.clamp(denom, min=1.0)
