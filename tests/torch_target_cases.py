"""Target-creator inputs shared by the CPU parity tests
(``test_torch_targets.py``) and the kernel tests (``test_torch_cuda.py``,
which run without jax): seeded numpy gt boxes, anchors, proposals, masks
and sampling priorities, at the creators' edge cases.

Cases: ``ties`` (priorities quantised to a few values, so that equal keys
straddle the positive and the negative thresholds), ``few_pos`` (fewer
positive candidates than the positive quota), ``no_gt`` (an image without a
valid gt box), ``small_pool`` (fewer candidates than ``n_sample``: every
candidate is taken, and the proposal side has unfilled slots), ``g1`` (one
gt slot); the kernel tests add ``g256`` (the kernels' most gt boxes) and
``train`` (the train step's shapes: 2 x 65520 anchors, 2000 proposals and 8
gts per image, bit-packed 832x1344 masks)."""

import numpy as np

from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, make_anchors
from tests.oracles import random_boxes

CPU_CASES = ("ties", "few_pos", "no_gt", "small_pool", "g1")
CARD_CASES = CPU_CASES + ("g256", "train")
TRAIN_HW = (832, 1344)


def quantised(rng, shape, levels):
    """Uniform [0, 1) priorities rounded down to ``levels`` values."""
    return (np.floor(rng.rand(*shape) * levels) / levels).astype(np.float32)


def priorities(rng, shape, levels=None):
    if levels:
        return quantised(rng, shape, levels), quantised(rng, shape, levels)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def gt_boxes(rng, n, g, h, w, min_size=6):
    bbox = np.stack([random_boxes(rng, g, h, w, min_size=min_size)
                     for _ in range(n)])
    return bbox, np.ones((n, g), bool)


def anchor_case(name):
    """dict(bbox (N, G, 4), bbox_valid (N, G), anchors (S, 4), img_size,
    pri_pos, pri_neg (N, S), n_sample)."""
    rng = np.random.RandomState(CARD_CASES.index(name) + 20)
    if name == "train":
        h, w = TRAIN_HW
        b = make_synthetic_train_batch(2, h, w, rng)
        bbox, valid = b["bbox"], b["bbox_valid"]
        scales, n_sample = (2, 4, 8, 16, 32), 256
    else:
        h, w = (96, 128) if name != "g256" else (320, 480)
        scales, n_sample = (1.0, 2.0, 4.0), 64
        g = {"g1": 1, "g256": 256, "few_pos": 2, "ties": 12}.get(name, 5)
        bbox, valid = gt_boxes(rng, 2, g, h, w)
        if name == "ties":
            n_sample = 8  # 4 positives of more, by 4 priority values
        if name == "few_pos":
            bbox[:, :, 2:] = bbox[:, :, :2] + 12  # small: few positives
            n_sample = 256
        if name == "no_gt":
            valid[0] = False
        if name == "g256":
            valid[1, 200:] = False
            bbox[0, 1] = bbox[0, 0]  # a duplicated gt: IoU ties
    cfg = MaskRCNNConfig(n_fg_class=3, anchor_scales=scales)
    fh, fw = (2, 2) if name == "small_pool" else (h // 16, w // 16)
    anchors = make_anchors(cfg, fh, fw)
    if name != "train":
        bbox[-1, 0] = anchors[len(anchors) // 2]  # an anchor equal to a gt
    pri_pos, pri_neg = priorities(rng, (2, len(anchors)),
                                  4 if name == "ties" else None)
    return dict(bbox=bbox, bbox_valid=valid, anchors=anchors,
                img_size=(h, w), pri_pos=pri_pos, pri_neg=pri_neg,
                n_sample=n_sample)


def rect_masks(bbox, h, w):
    """(N, G, H, W) uint8 masks: each gt's rounded rectangle, its top-left
    3x3 corner cut."""
    n, g = bbox.shape[:2]
    masks = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1, y2, x2 = np.round(bbox[i, k]).astype(int)
            masks[i, k, y1:y2, x1:x2] = 1
            masks[i, k, y1:y1 + 3, x1:x1 + 3] = 0
    return masks


def proposal_case(name):
    """dict(roi (N, P, 4), roi_valid (N, P), bbox (N, G, 4), label (N, G)
    int32, bbox_valid (N, G), masks (N, G, H, W) uint8 unpacked, pri_pos,
    pri_neg (N, P + G), n_sample)."""
    rng = np.random.RandomState(CARD_CASES.index(name) + 40)
    if name == "train":
        h, w = TRAIN_HW
        b = make_synthetic_train_batch(2, h, w, rng)
        bbox, valid, label = b["bbox"], b["bbox_valid"], b["label"]
        masks = np.unpackbits(b["mask"], axis=-1)
        p, n_sample, jittered = 2000, 512, 64
    else:
        h, w = 64, 96
        g = {"g1": 1, "g256": 256, "few_pos": 2}.get(name, 4)
        bbox, valid = gt_boxes(rng, 2, g, h, w, min_size=4)
        label = rng.randint(0, 5, bbox.shape[:2]).astype(np.int32)
        masks = rect_masks(bbox, h, w)
        p = {"small_pool": 10, "g256": 2000}.get(name, 60)
        n_sample = 32
        jittered = {"few_pos": 2, "small_pool": 4}.get(name, 16)
        if name == "no_gt":
            valid[0] = False
        if name == "g256":
            valid[1, 100:] = False
    roi = np.stack([random_boxes(rng, p, h, w, min_size=4)
                    for _ in range(2)])
    # jittered copies of gts: the positive candidates
    pick = rng.randint(0, bbox.shape[1], jittered)
    roi[:, :jittered] = np.clip(
        bbox[:, pick] + rng.randn(2, jittered, 4).astype(np.float32) * 2,
        0, [h, w, h, w]).astype(np.float32)
    roi_valid = rng.rand(2, p) > 0.1
    pri_pos, pri_neg = priorities(rng, (2, p + bbox.shape[1]),
                                  3 if name == "ties" else None)
    return dict(roi=roi, roi_valid=roi_valid, bbox=bbox, label=label,
                bbox_valid=valid, masks=masks, pri_pos=pri_pos,
                pri_neg=pri_neg, n_sample=n_sample)


def threshold_ties(priority, candidates, k):
    """Whether equal priorities straddle the top-k cut among the candidates
    of some row: the k-th and (k+1)-th largest candidate keys are equal."""
    for pri, cand in zip(priority, candidates):
        vals = np.sort(pri[cand])[::-1]
        if 0 < k < len(vals) and vals[k - 1] == vals[k]:
            return True
    return False
