"""Static bucket shapes and mask bit-packing, numpy copies of
``round_up``, ``bucket_shape`` and ``pack_mask_bits`` in
``mask_rcnn_tpu/data/loader.py`` (importing that package would import
jax)."""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_shape(h: int, w: int, min_size: int, max_size: int):
    """The static padded shape for a resized (h, w) image: orientation
    bucket with short side >= min_size, long side >= max_size, 64-aligned."""
    short = round_up(min_size, 64)
    long_ = round_up(max_size, 64)
    if w >= h:
        return (short if h <= short else round_up(h, 64),
                long_ if w <= long_ else round_up(w, 64))
    return (long_ if h <= long_ else round_up(h, 64),
            short if w <= short else round_up(w, 64))


def pack_mask_bits(mask: np.ndarray) -> np.ndarray:
    """(..., W) binary -> (..., W/8) uint8 bit-packed along the last axis
    (``np.packbits`` order: the first column is the high bit). The train
    step reads the packed form directly (kernel K8)."""
    if mask.shape[-1] % 8:
        raise ValueError(f"mask width must be a multiple of 8: {mask.shape}")
    return np.packbits(mask.astype(bool), axis=-1)
