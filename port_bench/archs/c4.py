"""Mask R-CNN C4 (Detectron's R-50-C4 and R-101-C4): the ResNet trunk cut
at res4 (stride 16), an RPN on its 1024 channels, and res5 as the RoI head
on RoIAlign's 7 bins of a 14-bin grid, with ``deconv6`` and the mask layer
after it. The interface is the one ``spec.py`` lists; the reference's C4
functions are those of ``reference/model.py`` and ``reference/train.py``.
"""

from __future__ import annotations

from port_bench import counts, trace, weights
from port_bench.counts import BLOCKS, BYTES, _out, conv
from port_bench.reference import model as R
from port_bench.reference import train as RT


def port_config(model):
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    from mask_rcnn_tpu_torch.models.rpn import ProposalConfig

    return MaskRCNNConfig(
        n_fg_class=model["n_fg_class"], n_layers=model["n_layers"],
        min_size=model["min_size"], max_size=model["max_size"],
        ratios=tuple(model["ratios"]),
        anchor_scales=tuple(float(s) for s in model["anchor_scales"]),
        mean=tuple(model["mean"]), feat_stride=model["feat_stride"],
        rpn_hidden=model["rpn_hidden"], roi_size=model["roi_size"],
        mask_size=model["mask_size"], pooling=model["pooling"],
        sampling_ratio=model["sampling_ratio"],
        proposal=ProposalConfig(**model["proposal"]),
        loc_normalize_mean=tuple(model["loc_normalize_mean"]),
        loc_normalize_std=tuple(model["loc_normalize_std"]),
        nms_thresh=model["nms_thresh"], score_thresh=model["score_thresh"],
        detections_per_im=model["detections_per_im"],
        compute_dtype=model["compute_dtype"],
        nms_topk_per_class=model["nms_topk_per_class"])


# ---------------------------------------------------------------------------
# Weights


def layout(model, stds):
    """[(path, (kind, shape or channels, std or scale))] in draw order."""
    blocks = BLOCKS[model["n_layers"]]
    n_class = model["n_fg_class"] + 1
    a = len(model["ratios"]) * len(model["anchor_scales"])
    hidden = model["rpn_hidden"]
    spec = [("extractor/conv1/W", ("normal", (64, 3, 7, 7),
                                   (2.0 / 147) ** 0.5)),
            ("extractor/bn1", ("affine", 64, 0.5))]
    for i, stage in enumerate(("res2", "res3", "res4")):
        weights._stage(spec, "extractor", stage, blocks[i])
    rpn = stds["rpn"]
    spec += [("rpn/conv1/W", ("normal", (hidden, 1024, 3, 3), rpn)),
             ("rpn/conv1/b", ("zeros", hidden)),
             ("rpn/loc/W", ("normal", (4 * a, hidden, 1, 1), rpn)),
             ("rpn/loc/b", ("zeros", 4 * a)),
             ("rpn/score/W", ("normal", (a, hidden, 1, 1), rpn)),
             ("rpn/score/b", ("zeros", a))]
    weights._stage(spec, "head", "res5", 3)
    spec += [("head/cls_loc/W", ("normal", (2048, 4 * n_class),
                                 stds["cls_loc"])),
             ("head/cls_loc/b", ("zeros", 4 * n_class)),
             ("head/score/W", ("normal", (2048, n_class), stds["score"])),
             ("head/score/b", ("zeros", n_class)),
             ("head/deconv6/W", ("normal", (2048, 256, 2, 2),
                                 stds["deconv6"])),
             ("head/deconv6/b", ("zeros", 256)),
             ("head/mask/W", ("normal", (model["n_fg_class"], 256, 1, 1),
                              stds["mask"])),
             ("head/mask/b", ("zeros", model["n_fg_class"]))]
    return spec


# ---------------------------------------------------------------------------
# Anchors, FLOPs and byte floors


def anchor_count(model, h, w):
    """Anchors of one image at the padded (h, w): A on each cell of the
    stride-``feat_stride`` map."""
    a = len(model["ratios"]) * len(model["anchor_scales"])
    s = model["feat_stride"]
    return (h // s) * (w // s) * a


def backbone_convs(model, h, w):
    """(per-stage lists of (flops, kind)) of one image at the padded
    (h, w): the stem, res2, res3, res4; and the C4 feature size."""
    blocks = BLOCKS[model["n_layers"]]
    h2, w2 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    stem = [(conv(1, h2, w2, 3, 64, 7), "input")]
    h4, w4 = _out(h2, 3, 2, 1), _out(w2, 3, 2, 1)
    res2, h4, w4 = counts._stage(h4, w4, "res2", blocks[0])
    res3, h8, w8 = counts._stage(h4, w4, "res3", blocks[1])
    res4, h16, w16 = counts._stage(h8, w8, "res4", blocks[2])
    return {"stem": stem, "res2": res2, "res3": res3, "res4": res4}, (h16,
                                                                      w16)


def rpn_flops(model, hf, wf):
    a = len(model["ratios"]) * len(model["anchor_scales"])
    return (conv(1, hf, wf, 1024, model["rpn_hidden"], 3)
            + conv(1, hf, wf, model["rpn_hidden"], 5 * a, 1))


def res5_flops(model):
    """One roi's res5 at the pooled 7x7 (stride 1 with the 14-bin
    RoIAlign of ``roi_size`` 14)."""
    s5 = model["roi_size"] // 7
    size = 7 if s5 > 1 else model["roi_size"]
    convs, _, _ = counts._stage(size, size, "res5", 3,
                                stride=1 if s5 > 1 else 2)
    return sum(f for f, _ in convs), size


def box_flops(model):
    n_class = model["n_fg_class"] + 1
    return 2 * 2048 * 5 * n_class  # cls_loc (4 n_class) and score


def mask_flops(model):
    _, size = res5_flops(model)
    deconv = 2 * size * size * 2048 * 256 * 4
    return deconv + conv(1, 2 * size, 2 * size, 256, model["n_fg_class"], 1)


def predict_flops(model, h, w, n_images, n_dets):
    """A predict step's FLOPs: ``n_images`` at the padded (h, w), the box
    head on the test proposals of each, and res5 with the mask branch on
    ``n_dets`` detections in all."""
    convs, (hf, wf) = backbone_convs(model, h, w)
    per_image = (sum(f for stage in convs.values() for f, _ in stage)
                 + rpn_flops(model, hf, wf))
    rois = model["proposal"]["n_test_post_nms"]
    res5, _ = res5_flops(model)
    return (n_images * (per_image + rois * (res5 + box_flops(model)))
            + n_dets * (res5 + mask_flops(model)))


def train_flops(model, train, h, w, n_images):
    """A train step's FLOPs, forward and backward, at the padded (h, w):
    conv1, bn1 and res2 frozen and cut from the gradient, so res3's first
    convolutions compute no input gradient; every other convolution and
    product computes its weight's gradient and its input's (each as much
    as its forward)."""
    convs, (hf, wf) = backbone_convs(model, h, w)
    fwd = sum(f for stage in convs.values() for f, _ in stage)
    bwd = 0
    for name in ("res3", "res4"):
        for i, (f, kind) in enumerate(convs[name]):
            first_block = i < 4
            bwd += f if (name == "res3" and first_block
                         and kind == "input") else 2 * f
    rpn = rpn_flops(model, hf, wf)
    pt = train["proposal_target"]
    rois = pt["n_sample"]
    pos = min(int(round(rois * pt["pos_ratio"])), rois)
    res5, _ = res5_flops(model)
    head = rois * (res5 + box_flops(model)) + pos * mask_flops(model)
    return n_images * (fwd + bwd + 3 * rpn + 3 * head)


def roi_align_bytes(n, hf, wf, rois, model, dtype):
    """K1's floor: the features read once, the rois read once, the pooled
    bins (7x7 of the 14-bin grid) written once."""
    b = BYTES[dtype]
    _, size = res5_flops(model)
    return (n * hf * wf * 1024 * b + n * rois * 16
            + n * rois * size * size * 1024 * b)


def roi_align_bwd_bytes(n, hf, wf, rois, model, dtype):
    """K7's floor: the pooled gradient read once, the rois read once, the
    features' gradient written once."""
    return roi_align_bytes(n, hf, wf, rois, model, dtype)


# ---------------------------------------------------------------------------
# Rooflines of the traced segment


def roi_align_floor(run, shapes, dets_slots):
    """Seconds of K1's floor over batches of padded ``shapes`` (and their
    image counts): the proposals' call and the detections' call each."""
    dtype = run.model["compute_dtype"]
    total = 0
    for (h, w), n in shapes:
        hf, wf = h // run.model["feat_stride"], w // run.model["feat_stride"]
        for rois in (run.model["proposal"]["n_test_post_nms"], dets_slots):
            total += roi_align_bytes(n, hf, wf, rois, run.model, dtype)
    return total / run.peaks["bytes_per_s"] if run.peaks else None


def serve_rooflines(run, summary, shapes):
    """``{"roi_align": (floor seconds, K1 device seconds)}`` of the traced
    segment's batches of padded ``shapes`` (and their image counts);
    raises when the trace holds another number of K1 launches than the
    batches make."""
    seconds, launches = trace.kernel(summary, "roi_align_fwd_kernel")
    if launches != 2 * len(shapes):
        raise RuntimeError(f"traced {launches} RoIAlign launches for "
                           f"{len(shapes)} batches")
    return {"roi_align": (roi_align_floor(run, shapes,
                                          run.model["detections_per_im"]),
                          seconds)}


def train_rooflines(run, summary, n_steps, batch):
    """``{"roi_align_bwd": (floor seconds, K7 device seconds)}`` of
    ``n_steps`` traced steps on batches shaped as ``batch``; raises when
    the trace holds another number of K7 launches than steps."""
    n, h, w = batch["image"].shape[:3]
    mc = run.model
    s = mc["feat_stride"]
    rois = run.cell.config["train"]["proposal_target"]["n_sample"]
    sec, launches = trace.kernel(summary, "roi_align_bwd_kernel")
    if launches != n_steps:
        raise RuntimeError(f"traced {launches} RoIAlign backward launches "
                           f"for {n_steps} steps")
    floor = n_steps * roi_align_bwd_bytes(
        n, h // s, w // s, rois, mc, mc["compute_dtype"])
    return {"roi_align_bwd": (floor / run.peaks["bytes_per_s"], sec)}


# ---------------------------------------------------------------------------
# The plain reference


detect = R.detect
mask_probs = R.mask_probs
train_loss = RT.train_loss


def score_rois(params, mc, features, rois, prec):
    """The box head on ``rois`` -> dict of ``cls_loc`` and ``score``."""
    return R.head_chunked(params["head"], mc, features, rois, prec)
