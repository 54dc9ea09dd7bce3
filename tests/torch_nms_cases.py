"""NMS inputs shared by the CPU parity tests (``test_torch_ops.py``) and
the kernel tests (``test_torch_cuda.py``, which run without jax): dyadic
boxes, and the edge cases of the tiled proposal NMS (K2)."""

import numpy as np


def dyadic_boxes(rng, n, size, lo, hi, clusters=None):
    """Integer boxes in a size x size image: every area, intersection and
    union is exact in float32, so the NMS predicate has no rounding
    ambiguity between implementations. With ``clusters``, boxes are jittered
    copies of that many seeds, so that suppression (and chains of it) is
    common, as among real proposals."""
    k = clusters or n
    y1 = rng.randint(0, size - lo, k)
    x1 = rng.randint(0, size - lo, k)
    hh = rng.randint(lo, hi, k)
    ww = rng.randint(lo, hi, k)
    if clusters:
        pick = rng.randint(0, k, n)
        jit = lambda e: rng.randint(-(e // 8) - 1, e // 8 + 2)  # noqa: E731
        y1 = np.clip(y1[pick] + jit(hh[pick]), 0, size - lo)
        x1 = np.clip(x1[pick] + jit(ww[pick]), 0, size - lo)
        hh = np.maximum(hh[pick] + jit(hh[pick]), 1)
        ww = np.maximum(ww[pick] + jit(ww[pick]), 1)
    y2 = np.minimum(y1 + hh, size)
    x2 = np.minimum(x1 + ww, size)
    return np.stack([y1, x1, y2, x2], axis=1).astype(np.float32)


def edge_boxes(rng, kind, n, size, lo, hi):
    """(B, N, 4) boxes and (B, N) validity of the edge cases of the tiled
    proposal NMS (K2): ``none_valid``; ``dups`` (runs of identical boxes,
    zero-area boxes, identical zero-area ones); ``exact_iou`` (pairs whose
    IoU is exactly 1/2, and pairs just above and below it, at thresh 0.5);
    ``batch3`` (three problems with 1100, 300 and 0 valid rows)."""
    valid = np.ones((1, n), bool)
    if kind in ("none_valid", "dups"):
        bbox = dyadic_boxes(rng, n, size, lo, hi, clusters=n // 4)[None]
    if kind == "none_valid":
        valid[:] = False
    elif kind == "dups":
        b = bbox[0]
        for start in range(0, n - 8, 37):  # runs of 1-7 copies
            b[start + 1:start + 1 + start % 7] = b[start]
        flat = rng.rand(n) < 0.15  # zero height or zero width
        b[flat, 2] = b[flat, 0]
        b[n // 2:n // 2 + 5] = [3.0, 4.0, 3.0, 9.0]  # identical, zero area
    elif kind == "exact_iou":
        # a (2h x w) box, its two halves (IoU 1/2 exactly: not > 0.5) and
        # the first half one row taller or shorter (just above or below
        # 1/2); integers keep every product exact. Two lone boxes first, so
        # that groups straddle the kernel's 64-box tiles.
        rows = [[2000, 0, 2004, 4], [2000, 10, 2004, 14]]
        for k in range(n // 4 + 1):
            y, x = 16 * (k % 60), 16 * (k // 60)
            h, w = rng.randint(2, 7), rng.randint(2, 15)
            rows += [[y, x, y + 2 * h, x + w], [y, x, y + h, x + w],
                     [y, x, y + h + (k % 3) - 1, x + w],
                     [y + h, x, y + 2 * h, x + w]]
        bbox = np.asarray(rows[:n], np.float32)[None]
    elif kind == "batch3":
        bbox = np.stack([dyadic_boxes(rng, n, size, lo, hi, clusters=c)
                         for c in (300, 100, 50)])
        valid = np.arange(n)[None] < np.array([[n], [300], [0]])
    return bbox, valid


def nms_case(seed, n, size, lo, hi, clusters):
    """(B, N, 4) score-sorted boxes, (B, N) scores and validity: dyadic
    boxes (``clusters`` an int or None), or an edge case (a str)."""
    rng = np.random.RandomState(seed)
    if isinstance(clusters, str):
        bbox, valid = edge_boxes(rng, clusters, n, size, lo, hi)
        score = np.sort(rng.permutation(n).astype(np.float32) / n)[::-1]
        return bbox, np.repeat(score[None], len(bbox), 0), valid
    bbox = dyadic_boxes(rng, n, size, lo, hi, clusters)
    score = np.sort(rng.permutation(n).astype(np.float32) / n)[::-1].copy()
    valid = rng.rand(n) > 0.05
    return bbox[None], score[None], valid[None]


# The tiled K2's edge cases, N > SMALL_MAX_N and not a multiple of 64 (the
# port's nms_padded takes nms_blocked): fewer survivors than max_out, so the
# scan reaches the ragged last tile; max_out reached inside the first tile;
# then edge_boxes' kinds. (n, max_out, thresh, image size, box sizes
# lo..hi, clusters or edge kind), as test_torch_ops.py's NMS_CASES.
NMS_EDGE_CASES = [
    (1100, 1000, 0.7, 256, 32, 128, 40),
    (1100, 5, 0.7, 1024, 8, 128, 300),
    (1100, 300, 0.7, 1024, 8, 128, "none_valid"),
    (1100, 400, 0.7, 256, 4, 64, "dups"),
    (1100, 600, 0.5, 0, 0, 0, "exact_iou"),
    (1100, 250, 0.7, 512, 8, 96, "batch3"),
]
