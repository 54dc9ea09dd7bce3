"""Deprecated dataset adapter (reference datasets/mask_rcnn.py:9-28 parity),
a copy of ``mask_rcnn_tpu/data/legacy.py``.

Wraps any dataset yielding ``(img, lbl_cls, lbl_ins)`` label-image triples
into the (img, bboxes, labels, masks) instance tuple contract.
"""

from __future__ import annotations

import warnings

import numpy as np

from mask_rcnn_tpu_torch.utils.geometry import label2instance_boxes


class MaskRcnnDataset:
    def __init__(self, dataset):
        warnings.warn(
            "MaskRcnnDataset is deprecated; implement get_example returning "
            "(img, bboxes, labels, masks) directly",
            DeprecationWarning,
        )
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get_example(self, i):
        img, lbl_cls, lbl_ins = self.dataset[i]
        labels, bboxes, masks = label2instance_boxes(lbl_ins, lbl_cls)
        return (
            img,
            bboxes.astype(np.float32),
            (labels - 1).astype(np.int32),
            masks.astype(np.int32),
        )

    __getitem__ = get_example
