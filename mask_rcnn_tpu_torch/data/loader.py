"""Static bucket shapes, the port of ``round_up``/``bucket_shape`` in
``mask_rcnn_tpu/data/loader.py``."""

from __future__ import annotations


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
