"""Anchor generation (host-side numpy), the port of
``mask_rcnn_tpu/ops/anchors.py``.

A base-16 anchor set over ratios x scales in (y1, x1, y2, x2), shifted over
the feature grid. Anchors depend only on the feature-map shape.
"""

from __future__ import annotations

import numpy as np


def generate_anchor_base(
    base_size: float = 16.0,
    ratios=(0.5, 1.0, 2.0),
    anchor_scales=(8.0, 16.0, 32.0),
) -> np.ndarray:
    """(A, 4) anchors centered on (base/2, base/2), ratio-major ordering."""
    py = base_size / 2.0
    px = base_size / 2.0
    anchor_base = np.zeros((len(ratios) * len(anchor_scales), 4), np.float32)
    for i, ratio in enumerate(ratios):
        for j, scale in enumerate(anchor_scales):
            h = base_size * scale * np.sqrt(ratio)
            w = base_size * scale * np.sqrt(1.0 / ratio)
            index = i * len(anchor_scales) + j
            anchor_base[index, 0] = py - h / 2.0
            anchor_base[index, 1] = px - w / 2.0
            anchor_base[index, 2] = py + h / 2.0
            anchor_base[index, 3] = px + w / 2.0
    return anchor_base


def enumerate_shifted_anchors(
    anchor_base: np.ndarray, feat_stride: int, height: int, width: int
) -> np.ndarray:
    """(H*W*A, 4) anchors: the base set shifted over every feature cell.

    Row ordering is cell-major then anchor, so RPN outputs flattened from
    (H, W, A) line up with anchors 1:1.
    """
    shift_y = np.arange(0, height * feat_stride, feat_stride)
    shift_x = np.arange(0, width * feat_stride, feat_stride)
    shift_x, shift_y = np.meshgrid(shift_x, shift_y)
    shift = np.stack(
        (shift_y.ravel(), shift_x.ravel(), shift_y.ravel(), shift_x.ravel()),
        axis=1,
    )
    a = anchor_base.shape[0]
    k = shift.shape[0]
    anchor = anchor_base.reshape((1, a, 4)) + shift.reshape((k, 1, 4))
    return anchor.reshape((k * a, 4)).astype(np.float32)
