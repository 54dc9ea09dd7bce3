"""Plain float32 Mask R-CNN training: the target creators (chainercv's
``AnchorTargetCreator`` and the reference's ``ProposalTargetCreator``,
sampling by given priorities), the five losses, and chainer's
MomentumSGD with weight decay on the trainable leaves.

A batch is the benchmark's padded train batch: image (N, H, W, 3) float32
mean-subtracted, bbox (N, G, 4), label (N, G) 0-based, bbox_valid (N, G),
mask (N, G, H, W/8) bit-packed along W, scale (N,). Priorities are
``{"anchor": (pos, neg), "proposal": (pos, neg)}`` of (N, S) and
(N, P + G) tensors: sampling without replacement takes the top of the
priorities among the candidates, ties to the lower index.
"""

from __future__ import annotations

import torch

from port_bench.reference import model as m


def _sample(priority, candidates, k):
    """(idx (N, k), picked (N, k)): the top-k priorities among the True
    candidates of each row."""
    top, idx = m.sort_desc(torch.where(candidates, priority, -torch.inf))
    k = min(k, candidates.shape[-1])
    return idx[:, :k], torch.isfinite(top[:, :k])


def gather_rows(x, idx):
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def anchor_targets(bbox, bbox_valid, anchor, img_hw, pri_pos, pri_neg, tc):
    """-> (loc (N, S, 4), label (N, S) in {-1, 0, 1})."""
    n, s = bbox.shape[0], anchor.shape[0]
    h, w = img_hw
    inside = ((anchor[:, 0] >= 0) & (anchor[:, 1] >= 0) & (anchor[:, 2] <= h)
              & (anchor[:, 3] <= w))
    iou = m.bbox_iou(anchor.expand(n, *anchor.shape), bbox)
    iou = torch.where(bbox_valid[:, None, :], iou, -1.0)
    iou = torch.where(inside[None, :, None], iou, -1.0)
    argmax = torch.argmax(iou, dim=-1)
    max_iou = torch.amax(iou, dim=-1)
    gt_max = torch.amax(iou, dim=1, keepdim=True)
    is_gt_argmax = ((iou == gt_max) & bbox_valid[:, None, :]
                    & (gt_max > 0)).any(dim=-1)
    label = torch.full(max_iou.shape, -1, dtype=torch.int32,
                       device=anchor.device)
    label = torch.where(inside & (max_iou < tc["neg_iou_thresh"]), 0, label)
    label = torch.where(inside & is_gt_argmax, 1, label)
    label = torch.where(inside & (max_iou >= tc["pos_iou_thresh"]), 1, label)

    pos_idx, pos_picked = _sample(pri_pos, label == 1,
                                  int(tc["pos_ratio"] * tc["n_sample"]))
    n_pos = pos_picked.sum(dim=-1, keepdim=True)
    neg_idx, neg_avail = _sample(pri_neg, label == 0, tc["n_sample"])
    rank = torch.arange(neg_idx.shape[-1], device=anchor.device)
    neg_picked = neg_avail & (rank < tc["n_sample"] - n_pos)
    keep = torch.zeros((n, s), dtype=torch.int32, device=anchor.device)
    keep.scatter_reduce_(1, pos_idx, pos_picked.to(torch.int32), "amax")
    keep.scatter_reduce_(1, neg_idx, neg_picked.to(torch.int32), "amax")
    label = torch.where(keep > 0, label, -1)
    return m.bbox2loc(anchor, gather_rows(bbox, argmax)), label


def _mask_crops(masks, gt_index, rois, out):
    """Bit-packed (N, G, H, W/8) masks, rois (N, Q, 4) rounded half to even
    and sampled as cv2 does at ``(i + .5) * crop / out - .5``, bilinear,
    then > 0.5 -> (N, Q, out, out) int32."""
    n, g, h, wb = masks.shape
    w = wb * 8
    q = rois.shape[1]
    r = torch.round(rois).to(torch.int64)
    i = torch.arange(out, dtype=torch.float32, device=rois.device)

    def axis(start, end, size):
        c = torch.clamp(end - start, min=1).to(torch.float32)[..., None]
        v = (i + 0.5) * (c / torch.full_like(c, out)) - 0.5
        v = torch.minimum(torch.clamp(v, min=0.0), c - 1.0)
        v = v + start.to(torch.float32)[..., None]
        lo = torch.floor(v).to(torch.int64)
        hi = torch.clamp(lo + 1, 0, size - 1)
        lo = torch.clamp(lo, 0, size - 1)
        return lo, hi, v - lo.to(torch.float32)

    y0, y1, ly = axis(r[..., 0], r[..., 2], h)
    x0, x1, lx = axis(r[..., 1], r[..., 3], w)
    base = (gt_index.to(torch.int64) * h)[..., None]
    rows = torch.gather(masks.reshape(n, g * h, wb), 1,
                        torch.cat([base + y0, base + y1], dim=-1)
                        .reshape(n, -1, 1).expand(-1, -1, wb))
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=masks.device)
    rows = ((rows[..., None] >> shifts) & 1).reshape(n, q, 2 * out, w)
    rows = rows.to(torch.float32)

    def cols(rw, xx):
        return torch.gather(rw, 3, xx[:, :, None, :].expand(n, q, out, out))

    a, b = rows[:, :, :out], rows[:, :, out:]
    wy0, wy1 = (1 - ly)[..., :, None], ly[..., :, None]
    wx0, wx1 = (1 - lx)[..., None, :], lx[..., None, :]
    v = (cols(a, x0) * (wy0 * wx0) + cols(a, x1) * (wy0 * wx1)
         + cols(b, x0) * (wy1 * wx0) + cols(b, x1) * (wy1 * wx1))
    return (v > 0.5).to(torch.int32)


def proposal_targets(roi, roi_valid, bbox, label, bbox_valid, mask, pri_pos,
                     pri_neg, tc, loc_mean, loc_std):
    """-> (sample_roi (N, ns, 4) positives first, gt_loc (N, ns, 4),
    gt_label (N, ns) with -1 unused, gt_mask (N, ns, M, M) with -1 off the
    positives)."""
    ns = tc["n_sample"]
    dev = roi.device
    cand = torch.cat([roi, bbox], dim=1)
    cand_valid = torch.cat([roi_valid, bbox_valid], dim=1)
    n = cand.shape[0]
    iou = torch.where(bbox_valid[:, None, :], m.bbox_iou(cand, bbox), -1.0)
    gt_of = torch.argmax(iou, dim=-1)
    no_gt = torch.where(bbox_valid.any(dim=-1, keepdim=True), -1.0, 0.0)
    max_iou = torch.where(cand_valid,
                          torch.maximum(torch.amax(iou, dim=-1), no_gt), -1.0)
    pos = max_iou >= tc["pos_iou_thresh"]
    neg = (max_iou < tc["neg_iou_thresh_hi"]) & (
        max_iou >= tc["neg_iou_thresh_lo"])

    quota = int(round(ns * tc["pos_ratio"]))
    pos_idx, pos_picked = _sample(pri_pos, pos, quota)
    n_pos = pos_picked.sum(dim=-1, keepdim=True)
    neg_idx, neg_avail = _sample(pri_neg, neg, ns)
    rank = torch.arange(neg_idx.shape[-1], device=dev)
    neg_picked = neg_avail & (rank < ns - n_pos)
    all_idx = torch.cat([pos_idx, neg_idx], dim=1)
    all_picked = torch.cat([pos_picked, neg_picked], dim=1)
    is_pos = torch.cat([pos_picked, torch.zeros_like(neg_picked)], dim=1)
    take = torch.sort((~all_picked).to(torch.uint8), dim=1,
                      stable=True).indices[:, :ns]
    sel = torch.gather(all_idx, 1, take)
    sel_valid = torch.gather(all_picked, 1, take)
    sel_pos = torch.gather(is_pos, 1, take)

    sample_roi = gather_rows(cand, sel)
    sel_gt = torch.gather(gt_of, 1, sel)
    lab = torch.gather(label.to(torch.int64), 1, sel_gt) + 1
    lab = torch.where(sel_valid, torch.where(sel_pos, lab, 0), -1)
    loc = m.bbox2loc(sample_roi, gather_rows(bbox, sel_gt))
    loc = ((loc - torch.tensor(loc_mean, device=dev))
           / torch.tensor(loc_std, device=dev))
    size = tc["mask_size"]
    crops = _mask_crops(mask, sel_gt[:, :quota].contiguous(),
                        sample_roi[:, :quota].contiguous(), size)
    gt_mask = torch.full((n, ns, size, size), -1, dtype=torch.int32,
                         device=dev)
    gt_mask[:, :quota] = torch.where(sel_pos[:, :quota, None, None], crops,
                                     -1)
    return sample_roi, loc, lab, gt_mask


# ---------------------------------------------------------------------------
# Losses: label -1 ignored; each normalised by its count of labels >= 0


def smooth_l1(x, t, weight, sigma):
    s2 = sigma ** 2
    d = weight * (x - t)
    a = torch.abs(d)
    flag = (a < 1.0 / s2).to(x.dtype)
    return torch.sum(flag * (s2 / 2.0) * d * d + (1 - flag) * (a - 0.5 / s2))


def loc_loss(pred, gt, label, sigma):
    weight = (label > 0).to(pred.dtype)[..., None].expand(gt.shape)
    return smooth_l1(pred, gt, weight, sigma) / torch.clamp(
        torch.sum((label >= 0).to(pred.dtype)), min=1.0)


def sigmoid_ce(logits, labels):
    valid = labels >= 0
    t = torch.clamp(labels, min=0).to(logits.dtype)
    loss = (torch.clamp(logits, min=0.0) - logits * t
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.sum(torch.where(valid, loss, 0.0)) / torch.clamp(
        torch.sum(valid.to(logits.dtype)), min=1.0)


def softmax_ce(logits, labels):
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, torch.clamp(labels, min=0).long()[:, None])
    loss = torch.where(valid, -picked[:, 0], 0.0)
    return torch.sum(loss) / torch.clamp(torch.sum(valid.to(logits.dtype)),
                                         min=1.0)


TERMS = ("rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss", "roi_cls_loss",
         "roi_mask_loss")


def train_loss(params, cfg, batch, priorities, prec):
    """-> (loss, {term: value}) of one padded batch."""
    mc, tr = cfg["model"], cfg["train"]
    x = batch["image"].permute(0, 3, 1, 2).float()
    n, _, h, w = x.shape
    feats = m.backbone(params["extractor"], x, mc["n_layers"], prec,
                       train=True)
    locs, scores = m.rpn(params["rpn"], feats, prec)
    anchor = m.anchors(mc, feats.shape[2], feats.shape[3], x.device)
    pt, at = tr["proposal_target"], tr["anchor_target"]
    with torch.no_grad():
        props = [m.propose(mc, locs[i].detach(), scores[i].detach(), anchor,
                           (h, w), train=True) for i in range(n)]
        rois = torch.stack([p[0] for p in props])
        rois_valid = torch.stack([p[1] for p in props])
        sample_roi, gt_loc, gt_label, gt_mask = proposal_targets(
            rois, rois_valid, batch["bbox"], batch["label"],
            batch["bbox_valid"], batch["mask"], *priorities["proposal"], pt,
            mc["loc_normalize_mean"], mc["loc_normalize_std"])
        gt_rpn_loc, gt_rpn_label = anchor_targets(
            batch["bbox"], batch["bbox_valid"], anchor, (h, w),
            *priorities["anchor"], at)

    s = pt["n_sample"]
    q = min(int(round(s * pt["pos_ratio"])), s)
    n_class = mc["n_fg_class"] + 1
    cls_locs, cls_scores, masks = [], [], []
    for i in range(n):
        out = m.head(params["head"], mc, feats[i:i + 1], sample_roi[i], prec,
                     bbox=True, mask=True, mask_rows=slice(0, q))
        cls_locs.append(out["cls_loc"])
        cls_scores.append(out["score"])
        masks.append(out["mask"])
    cls_locs = torch.cat(cls_locs).reshape(n * s, n_class, 4)
    cls_scores = torch.cat(cls_scores)
    masks = torch.cat(masks)  # (n q, n_fg, M, M)

    lab = gt_label.reshape(-1)
    picked = torch.gather(cls_locs, 1, torch.clamp(lab, min=0)[:, None, None]
                          .expand(-1, 1, 4))[:, 0]
    sel = torch.clamp(gt_label[:, :q].reshape(-1) - 1, min=0)
    picked_masks = masks[torch.arange(len(sel), device=x.device), sel]
    terms = {
        "rpn_loc_loss": loc_loss(locs.reshape(-1, 4),
                                 gt_rpn_loc.reshape(-1, 4),
                                 gt_rpn_label.reshape(-1), tr["rpn_sigma"]),
        "rpn_cls_loss": sigmoid_ce(scores.reshape(-1),
                                   gt_rpn_label.reshape(-1)),
        "roi_loc_loss": loc_loss(picked, gt_loc.reshape(-1, 4), lab,
                                 tr["roi_sigma"]),
        "roi_cls_loss": softmax_ce(cls_scores, lab),
        "roi_mask_loss": sigmoid_ce(
            picked_masks, gt_mask[:, :q].reshape(-1, mc["mask_size"],
                                                 mc["mask_size"])),
    }
    return sum(terms.values()), terms


# ---------------------------------------------------------------------------
# The optimizer: chainer MomentumSGD with WeightDecay; conv1, bn1, res2 and
# every bn* affine frozen


def trainable(path) -> bool:
    keys = path.split("/")
    if keys[0] == "extractor" and keys[1] in ("conv1", "bn1", "res2"):
        return False
    return not any(k.startswith("bn") for k in keys)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def sgd_step(flat, velocity, grads, lr, momentum, weight_decay):
    """In place: ``v = -lr (g + wd w) + m v; w = w + v``."""
    with torch.no_grad():
        for k, g in grads.items():
            u = (flat[k] * weight_decay + g) * -lr
            velocity[k].mul_(momentum).add_(u)
            flat[k].add_(velocity[k])
