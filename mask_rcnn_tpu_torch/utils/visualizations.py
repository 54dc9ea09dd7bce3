"""Drawing instance predictions, the port of
``mask_rcnn_tpu/utils/visualizations.py`` (the reference's fcn tiling and
colormaps, utils/visualizations.py:12-127).

The drawing (contours, rectangles, captions, the blend) is cv2's, as in the
JAX package, so a picture here is the JAX package's bit for bit. cv2 is
imported inside the functions that draw: where it is missing they raise
``ImportError`` naming it. ``label_colormap`` and ``get_tile_image`` are
numpy alone.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np


def require_cv2():
    """The cv2 module, or ``ImportError`` saying that drawing needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "drawing instance predictions needs cv2 (opencv-python), and it "
            f"does not import here: {e}") from e
    return cv2


def label_colormap(n: int = 256) -> np.ndarray:
    """VOC-style colormap: (n, 3) uint8 (the bit-shuffling construction)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def draw_instance_bboxes(
    img: np.ndarray,
    bboxes: np.ndarray,
    labels: np.ndarray,
    n_class: int,
    masks: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    captions: Optional[Sequence[str]] = None,
    alpha: float = 0.7,
) -> np.ndarray:
    """Render instance boxes/masks/captions onto an RGB image.

    bboxes are (R, 4) (y1, x1, y2, x2); labels index a per-class colormap.
    """
    cv2 = require_cv2()
    img = img.astype(np.uint8).copy()
    cmap = label_colormap(max(n_class + 1, 256))
    overlay = img.copy()
    for i in range(len(bboxes)):
        color = tuple(int(c) for c in cmap[int(labels[i]) % 256])
        if masks is not None and i < len(masks):
            m = masks[i].astype(bool)
            overlay[m] = (
                alpha * np.asarray(color) + (1 - alpha) * overlay[m]
            ).astype(np.uint8)
            contours, _ = cv2.findContours(
                masks[i].astype(np.uint8),
                cv2.RETR_EXTERNAL,
                cv2.CHAIN_APPROX_SIMPLE,
            )
            cv2.drawContours(overlay, contours, -1, color, 1)
    img = cv2.addWeighted(overlay, 0.7, img, 0.3, 0)
    for i in range(len(bboxes)):
        y1, x1, y2, x2 = [int(round(v)) for v in bboxes[i]]
        color = tuple(int(c) for c in cmap[int(labels[i]) % 256])
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        if captions is not None:
            caption = captions[i]
        elif scores is not None:
            caption = f"{int(labels[i])}: {scores[i]:.2f}"
        else:
            caption = str(int(labels[i]))
        cv2.putText(
            img, caption, (x1, max(y1 - 3, 10)),
            cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1, cv2.LINE_AA,
        )
    return img


def get_tile_image(imgs: List[np.ndarray], tile_shape=None) -> np.ndarray:
    """Tile images into a grid (fcn.utils.get_tile_image equivalent)."""
    n = len(imgs)
    if tile_shape is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = tile_shape
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    out = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        out[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    return out


def visualize_instance_segmentation(
    img, gt_bboxes, gt_labels, gt_masks,
    pred_bboxes, pred_labels, pred_masks, pred_scores,
    n_class: int,
) -> np.ndarray:
    """Side-by-side GT vs prediction panel."""
    viz_gt = draw_instance_bboxes(
        img, gt_bboxes, gt_labels, n_class, masks=gt_masks
    )
    viz_pred = draw_instance_bboxes(
        img, pred_bboxes, pred_labels, n_class, masks=pred_masks,
        scores=pred_scores,
    )
    return get_tile_image([viz_gt, viz_pred], (1, 2))


def draw_instance_boxes(img, boxes, instance_classes, n_class, masks=None,
                        captions=None):
    """Deprecated alias kept for reference-API compatibility
    (reference utils/visualizations.py:12-21)."""
    warnings.warn(
        "draw_instance_boxes is deprecated, please use draw_instance_bboxes"
    )
    return draw_instance_bboxes(
        img, boxes, instance_classes, n_class, masks=masks, captions=captions
    )
