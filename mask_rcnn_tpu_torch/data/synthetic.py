"""Synthetic training batches, a numpy copy of
``mask_rcnn_tpu/data/synthetic.py::make_synthetic_train_batch`` (importing
that package would import jax)."""

from __future__ import annotations

import numpy as np

from mask_rcnn_tpu_torch.data.loader import pack_mask_bits


def make_synthetic_train_batch(n, h, w, rng, max_boxes=8, n_fg_class=80):
    """In-memory padded train batch at (n, h, w): random images,
    ``max_boxes`` axis-aligned gt rectangles per image with matching
    bit-packed masks. ``rng`` is a ``np.random.RandomState``; the same seed
    gives the JAX package's batch."""
    g = max_boxes
    images = (rng.randn(n, h, w, 3) * 60).astype(np.float32)
    bbox = np.zeros((n, g, 4), np.float32)
    label = np.zeros((n, g), np.int32)
    valid = np.ones((n, g), bool)
    mask = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1 = rng.randint(0, h - 200)
            x1 = rng.randint(0, w - 200)
            y2, x2 = y1 + rng.randint(60, 200), x1 + rng.randint(60, 200)
            bbox[i, k] = (y1, x1, y2, x2)
            label[i, k] = rng.randint(0, n_fg_class)
            mask[i, k, y1:y2, x1:x2] = 1
    return {
        "image": images,
        "bbox": bbox,
        "label": label,
        "bbox_valid": valid,
        "mask": pack_mask_bits(mask),
        "scale": np.full((n,), 1.25, np.float32),
    }
