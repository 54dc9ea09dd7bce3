"""Interactive dataset viewer, the port of
``mask_rcnn_tpu/data/view_dataset.py`` (the reference's
datasets/view_dataset.py): each example's ground truth drawn in a cv2
window; n = next, p = previous, q = quit. Needs cv2 (imported when the
viewer starts) and a display."""

from __future__ import annotations

import numpy as np

from mask_rcnn_tpu_torch.utils.visualizations import (
    draw_instance_bboxes,
    require_cv2,
)


def view_dataset(dataset, class_names=None, window="dataset"):
    cv2 = require_cv2()
    n_class = len(class_names) if class_names else 256
    i = 0
    while True:
        e = dataset[i]
        img, bboxes, labels, masks = e[:4]
        viz = draw_instance_bboxes(
            img, bboxes, labels, n_class, masks=np.asarray(masks, bool)
        )
        cv2.imshow(window, viz[:, :, ::-1])
        key = cv2.waitKey(0) & 0xFF
        if key == ord("q"):
            break
        if key == ord("n"):
            i = (i + 1) % len(dataset)
        elif key == ord("p"):
            i = (i - 1) % len(dataset)
    cv2.destroyWindow(window)
