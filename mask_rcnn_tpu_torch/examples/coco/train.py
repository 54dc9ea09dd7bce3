"""COCO training (reference examples/coco/train.py parity): train2014 +
valminusminival, evaluation on minival; min 800 / max 1333, anchor scales
(2, 4, 8, 16, 32). The root is ``$COCO_ROOT`` (default
``~/data/datasets/COCO``).

    python -m mask_rcnn_tpu_torch.examples.coco.train [flags]
"""

import os

from mask_rcnn_tpu_torch.examples import train_common


def main(argv=None):
    from mask_rcnn_tpu_torch.data import (
        COCOInstanceSegmentationDataset,
        ConcatDataset,
    )

    args = train_common.parse_args(
        dataset_defaults=dict(max_epoch=(180e3 * 8) / 118287), argv=argv
    )
    root = os.environ.get("COCO_ROOT", "~/data/datasets/COCO")
    train_data = ConcatDataset(
        COCOInstanceSegmentationDataset("train", root=root),
        COCOInstanceSegmentationDataset("valminusminival", root=root),
    )
    test_data = COCOInstanceSegmentationDataset(
        "minival", root=root, use_crowd=True, return_crowd=True,
        return_area=True,
    )
    return train_common.train(
        args,
        train_data,
        test_data,
        class_names=test_data.class_names,
        dataset_kind="coco",
        min_size=800,
        max_size=1333,
        anchor_scales=(2, 4, 8, 16, 32),
    )


if __name__ == "__main__":
    main()
