"""Training and evaluation transforms, the port of
``mask_rcnn_tpu/data/transforms.py`` without cv2.

Train mode: scale so the short side is ``min_size`` capped by ``max_size``
(bilinear, cv2 ``INTER_LINEAR`` semantics through
``utils/masks.py::resize_bilinear``), mean subtraction, bbox rescale,
nearest-neighbour mask resize with cv2 ``INTER_NEAREST``'s source index,
random horizontal flip of image, bboxes and masks. Returns HWC float32 plus
the scale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mask_rcnn_tpu_torch.utils.masks import resize_bilinear


def compute_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    scale = 1.0
    if min_size:
        scale = min_size / min(h, w)
    if max_size and scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale


def nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2 ``INTER_NEAREST``'s source index of each of ``dst`` outputs:
    ``floor(d * (1 / (dst / src)))`` in double, clamped to ``src - 1``."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def resize_example(img, bboxes, masks, min_size, max_size,
                   keep_uint8=False):
    h, w = img.shape[:2]
    scale = compute_scale(h, w, min_size, max_size)
    # cv2's dsize for fx = fy = scale (round half to even)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = resize_bilinear(torch.from_numpy(np.asarray(img, np.float32)),
                          nh, nw, scale, scale).numpy()
    if keep_uint8:
        # cv2 interpolates uint8 in fixed point; this rounds the float
        # result, within one level of it
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    bboxes = bboxes * np.asarray([nh / h, nw / w, nh / h, nw / w],
                                 np.float32)
    if len(masks):
        masks = np.asarray(masks).astype(np.uint8)
        masks = masks[:, nearest_index(h, nh)][:, :, nearest_index(w, nw)]
    else:
        masks = np.zeros((0, nh, nw), np.uint8)
    return out, bboxes.astype(np.float32), masks, scale


def flip_horizontal(img, bboxes, masks):
    w = img.shape[1]
    img = img[:, ::-1].copy()
    x1 = w - bboxes[:, 3]
    x2 = w - bboxes[:, 1]
    bboxes = np.stack([bboxes[:, 0], x1, bboxes[:, 2], x2], axis=1)
    masks = masks[:, :, ::-1].copy()
    return img, bboxes.astype(np.float32), masks


class MaskRCNNTransform:
    """Callable transform: example tuple -> (img HWC f32 mean-subtracted,
    bboxes, labels, masks uint8, scale). The flip draws ``rng.rand()`` once
    per training example, as the JAX package's does, so the same
    ``RandomState`` gives the same flips."""

    def __init__(self, min_size: int, max_size: int,
                 mean: Tuple[float, float, float], train: bool = True,
                 rng: Optional[np.random.RandomState] = None,
                 keep_uint8: bool = False):
        """``keep_uint8`` keeps uint8 images (mean subtraction on the
        device, 4x less host-to-device traffic)."""
        self.min_size = min_size
        self.max_size = max_size
        self.mean = np.asarray(mean, np.float32)
        self.train = train
        self.rng = rng or np.random.RandomState()
        self.keep_uint8 = keep_uint8

    def __call__(self, example):
        img, bboxes, labels, masks = example[:4]
        if not self.train:
            img = img.astype(np.float32) - self.mean
            return img, bboxes, labels, masks.astype(np.uint8), 1.0
        img, bboxes, masks, scale = resize_example(
            img, bboxes, masks, self.min_size, self.max_size,
            keep_uint8=self.keep_uint8,
        )
        if not self.keep_uint8:
            img = img - self.mean
        if self.rng.rand() < 0.5:
            img, bboxes, masks = flip_horizontal(img, bboxes, masks)
        return img, bboxes, labels, masks.astype(np.uint8), scale
