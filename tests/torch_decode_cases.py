"""Detection-decode inputs shared by the CPU parity tests
(``test_torch_decode.py``, against the JAX package) and the kernel tests
(``test_torch_cuda.py``, which run without jax): the edge cases of the
decode's selection (per-class top-k, per-class NMS, the rounded-zero-area
drop and the final top ``detections_per_im``)."""

import numpy as np

from tests.oracles import random_boxes

# name -> (config overrides, input options). The CPU cases are small (5
# classes, 40 rois, 10 detections, top-16 a class); ``DECODE_CARD_CASES``
# add the serving widths.
_SMALL = dict(n_fg_class=5, detections_per_im=10, nms_topk_per_class=16)
DECODE_CASES = {
    # exact probability ties within a class (repeated logit rows) and
    # across classes (repeated logits within a row); integer logits, so
    # equal logit rows give equal probabilities bit for bit
    "ties": (_SMALL, dict(logits="ties")),
    "score_thresh_0": (dict(_SMALL, score_thresh=0.0), {}),
    "k_at_least_rp": (dict(_SMALL, nms_topk_per_class=40), {}),
    "k_0": (dict(_SMALL, nms_topk_per_class=0), {}),
    "invalid_rois": (_SMALL, dict(invalid=0.6)),
    # thin rois whose decoded boxes round to a zero height
    "zero_area": (dict(_SMALL, score_thresh=0.0), dict(thin=0.5)),
    "ties_k_0_thresh_0": (dict(_SMALL, nms_topk_per_class=0,
                               score_thresh=0.0), dict(logits="ties")),
}
_WIDE = dict(n_fg_class=80, detections_per_im=100, nms_topk_per_class=256)
DECODE_CARD_CASES = {
    **DECODE_CASES,
    "all_invalid_image": (_SMALL, dict(invalid_image=True)),
    "all_invalid_class": (_SMALL, dict(dead_class=True)),
    "fewer_than_d": (dict(_SMALL, score_thresh=0.7), {}),
    "rp1000": (_WIDE, dict(rp=1000, image=(640, 1066))),
    "rp1000_thresh_0": (dict(_WIDE, score_thresh=0.0),
                        dict(rp=1000, image=(640, 1066))),
    "rp1000_ties_k_0": (dict(_WIDE, nms_topk_per_class=0),
                        dict(rp=1000, image=(640, 1066), logits="ties")),
    "rp2000": (_WIDE, dict(rp=2000, image=(640, 1066))),
    "rp2000_thresh_0": (dict(_WIDE, score_thresh=0.0),
                        dict(rp=2000, image=(640, 1066))),
}


def decode_case(name, seed=0):
    """(config overrides, (roi, roi_valid, cls_loc, score, sizes, scales))
    of case ``name`` (``DECODE_CARD_CASES``), numpy, batch of two images,
    from ``seed``."""
    cfg, opt = DECODE_CARD_CASES[name]
    rng = np.random.RandomState(seed)
    n, rp = 2, opt.get("rp", 40)
    n_class = cfg["n_fg_class"] + 1
    h, w = opt.get("image", (80, 120))
    scales = np.array([1.25, 1.0], np.float32)
    sizes = np.array([[h - 20, w - 30], [h, w]], np.float32)
    roi = np.stack([random_boxes(rng, rp, h * s, w * s, min_size=4)
                    for s in scales])
    thin = rng.rand(n, rp) < opt.get("thin", 0.0)
    roi[..., 2] = np.where(thin, roi[..., 0] + 0.3, roi[..., 2])
    valid = rng.rand(n, rp) > opt.get("invalid", 0.2)
    if opt.get("invalid_image"):
        valid[1] = False
    cls_loc = (rng.randn(n, rp, n_class * 4) * 0.5).astype(np.float32)
    cls_loc[thin] = 0.0  # the decoded box is the thin roi itself
    if opt.get("logits") == "ties":
        rows = rng.randint(-2, 3, (6, n_class)) * 4
        rows[:, 2] = rows[:, 1]  # classes 1 and 2 tie in every row
        score = rows[rng.randint(0, 6, (n, rp))].astype(np.float32)
    else:
        score = (rng.randn(n, rp, n_class) * 2).astype(np.float32)
    if opt.get("dead_class"):
        score[..., 3] = -30.0  # probability far below any threshold
    return cfg, (roi, valid, cls_loc, score, sizes, scales)
