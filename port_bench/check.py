"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference (``port_bench/reference``) run on the
same raw inputs, weights and priorities.

Serving (each sampled image, at its batch's padded shape):

* ``score_gap``: the widest gap between a served detection's score and the
  reference's probability of that class at the same proposal (the anchor
  whose decoded box lies closest to the served box); a served detection
  that no anchor's box overlaps by half scores its whole score;
* ``box_gap``: the widest ``1 - IoU`` between a served box and the
  reference's box of that class at that proposal;
* ``mask_share``: the largest share, over the images, of the served
  masks' pixels (of their union with the reference's) that differ from
  the reference's paste, summed over the image's detections;
* ``miss_share``: the largest share, over the images, of the reference's
  own detections that scored above what a detection had to beat to be
  served (the threshold, or the image's lowest served score when it
  served the maximum) and have no served detection of their class that
  overlaps them by half.

Training (the first three steps):

* ``loss_gap``: the widest relative gap of a step's loss (the five terms'
  sum);
* ``grad_gap``: the worst trainable leaf's gap between the norms of the
  first gradient (worked out from the velocity after step 1), against the
  larger of the reference leaf's norm and the median leaf's;
* ``update_gap``: the same for the parameters' change over three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (the others move by round-off alone);
* ``grad_diff``: the median leaf's norm of the difference of the first
  gradients, on the same scale: the norm gaps are blind to an error that
  is uncorrelated with the gradient, which rounding is, so this is the
  number that the float8 control fails.

Beside them, as readings: each loss term's widest relative gap
(``gap.<term>``), which shows where the loss gap comes from.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from port_bench.reference import model as R
from port_bench.reference import train as RT

# the numbers that ``correct`` needs a limit for; the others are readings
COMPARED = ("score_gap", "box_gap", "mask_share", "miss_share", "loss_gap",
            "grad_gap", "update_gap", "grad_diff")
TWINS = 8


def _iou_np(a, b):
    return R.bbox_iou(torch.as_tensor(a)[None], torch.as_tensor(b)[None])[0]


def serve_case(arch, params, mc, img, padded, served, prec_ref=R.FULL):
    """Numbers of one image: ``served`` = (boxes (R, 4), masks (R, H, W)
    bool, labels (R,), scores (R,)) as the timed path returned them;
    ``arch`` (``archs/<name>.py``) gives the reference's model."""
    dev = next(iter(RT.flatten(params).values())).device
    boxes, masks, labels, scores = served
    with torch.no_grad():
        d = arch.detect(params, mc, img, padded, prec_ref, dev)
        feat, scale = d["features"], d["scale"]
        size = img.shape[1:]
        out = {"score_gap": 0.0, "box_gap": 0.0, "mask_share": 0.0,
               "miss_share": 0.0, "served": len(boxes)}
        if len(boxes):
            sb = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
            scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
            # each anchor's proposal as the decode sees it: in the image's
            # coordinates, clipped to the image
            anchor_img = R.clip(d["anchor_rois"] / scale_t, *size)
            iou = R.bbox_iou(sb, anchor_img)
            near, idx = iou.topk(min(TWINS, iou.shape[1]), dim=1)
            cand, inv = torch.unique(idx.reshape(-1), return_inverse=True)
            rois = d["anchor_rois"][cand]
            o = arch.score_rois(params, mc, feat, rois, prec_ref)
            prob, cbox = R.class_boxes(mc, rois, o["cls_loc"], o["score"],
                                       size, scale)
            inv = inv.reshape(idx.shape)
            lab = torch.as_tensor(labels, device=dev).long() + 1
            for r in range(len(boxes)):
                ok = near[r] >= 0.5
                if not bool(ok.any()):
                    out["score_gap"] = max(out["score_gap"], float(scores[r]))
                    out["box_gap"] = 1.0
                    continue
                rows = inv[r][ok]
                ious = R.bbox_iou(sb[r:r + 1], cbox[rows, lab[r]])[0]
                best = int(torch.argmax(ious))
                out["box_gap"] = max(out["box_gap"], 1.0 - float(ious[best]))
                out["score_gap"] = max(out["score_gap"], abs(
                    float(scores[r]) - float(prob[rows[best], lab[r]])))
            probs = arch.mask_probs(params, mc, feat, sb,
                                    torch.as_tensor(labels, device=dev),
                                    scale, prec_ref)
            ref_masks = R.paste(boxes, probs.cpu().numpy(), *size)
            diffs = unions = 0
            for r in range(len(boxes)):
                diffs += np.count_nonzero(ref_masks[r] != masks[r])
                unions += np.count_nonzero(ref_masks[r] | masks[r])
            out["mask_share"] = diffs / max(unions, 1)
        d_max = mc["detections_per_im"]
        floor = (float(np.min(scores)) if len(scores) >= d_max
                 else mc["score_thresh"])
        rb = d["boxes"].cpu().numpy()
        rl = d["labels"].cpu().numpy()
        rs = d["scores"].cpu().numpy()
        owed = missed = 0
        for k in range(len(rb)):
            if rs[k] <= floor:
                continue
            owed += 1
            same = labels == rl[k]
            hit = same.any() and bool(
                (_iou_np(rb[k:k + 1], boxes[same])[0] >= 0.5).any())
            missed += not hit
        out["miss_share"] = missed / owed if owed else 0.0
    return out


def serve_numbers(arch, params, mc, cases, prec_ref=R.FULL):
    """The widest of each number over ``cases`` = [(image, padded (H, W),
    served)]."""
    nums = [serve_case(arch, params, mc, img, padded, served, prec_ref)
            for img, padded, served in cases]
    out = {k: max(n[k] for n in nums) for k in
           ("score_gap", "box_gap", "mask_share", "miss_share")}
    out["detections_compared"] = sum(n["served"] for n in nums)
    return out


# ---------------------------------------------------------------------------
# Training


def reference_steps(arch, cfg, params, batches, priorities, prec=R.FULL):
    """The reference's first steps from ``params`` (updated in place) ->
    (losses [{term: float}], first gradient {leaf: tensor}, leaves)."""
    tr = cfg["train"]
    flat = RT.flatten(params)
    names = [k for k in flat if RT.trainable(k)]
    for k in names:
        flat[k].requires_grad_(True)
    vel = {k: torch.zeros_like(flat[k]) for k in names}
    losses, g1 = [], None
    for batch, pri in zip(batches, priorities):
        loss, terms = arch.train_loss(params, cfg, batch, pri, prec)
        grads = torch.autograd.grad(loss, [flat[k] for k in names])
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        if g1 is None:
            g1 = {k: g.detach().clone() for k, g in zip(names, grads)}
        RT.sgd_step(flat, vel, dict(zip(names, grads)), tr["lr"],
                    tr["momentum"], tr["weight_decay"])
        del loss, terms, grads
    for k in names:
        flat[k].requires_grad_(False)
    return losses, g1, flat


def _scaled(prog, ref, leaves, measure):
    """``measure(prog leaf, ref leaf)`` of each leaf over the larger of
    the reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in leaves}
    median = statistics.median(norms.values())
    return [measure(prog[k], ref[k]) / max(norms[k], median) for k in leaves]


def _worst_leaf(prog, ref, leaves):
    return max(_scaled(prog, ref, leaves,
                       lambda p, r: abs(float(p.norm()) - float(r.norm()))))


def _leaf_diffs(prog, ref, leaves):
    return _scaled(prog, ref, leaves, lambda p, r: float((p - r).norm()))


def train_numbers(w0, ref, prog):
    """``w0``: the weights before step 1 ({leaf: tensor}); ``ref`` and
    ``prog``: dicts of ``losses`` (three steps' terms), ``grad`` (first
    gradient by leaf) and ``w3`` (leaves after step 3)."""
    pairs = list(zip(prog["losses"], ref["losses"]))
    loss_gap = max(abs(sum(p[k] for k in RT.TERMS) - sum(r.values()))
                   / abs(sum(r.values())) for p, r in pairs)
    terms = {"gap." + k: max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
                             for p, r in pairs) for k in RT.TERMS}
    leaves = sorted(ref["grad"])
    g_norm = {k: float(ref["grad"][k].norm()) for k in leaves}
    median = statistics.median(g_norm.values())
    moved = [k for k in leaves if g_norm[k] >= 1e-3 * median]
    d_ref = {k: ref["w3"][k] - w0[k] for k in moved}
    d_prog = {k: prog["w3"][k] - w0[k] for k in moved}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"], leaves),
            "update_gap": _worst_leaf(d_prog, d_ref, moved),
            "grad_diff": statistics.median(
                _leaf_diffs(prog["grad"], ref["grad"], leaves)),
            "leaves_compared": len(moved), **terms}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every limited number at most its
    limit; a number without a limit fails."""
    rows = [(k, float(numbers[k]), limits[k]) for k in sorted(limits)]
    missing = [k for k in numbers if k in COMPARED and k not in limits]
    ok = bool(limits) and not missing and all(
        np.isfinite(v) and v <= lim for _, v, lim in rows)
    rows += [(k, numbers[k], None) for k in missing]
    return ok, rows
