"""VOC/SBD training (reference examples/voc/train.py parity): SBD
train/val, min 600 / max 1000, anchor scales (4, 8, 16, 32). The root is
``$SBD_ROOT`` (default ``~/data/datasets/VOC/benchmark_RELEASE/dataset``);
its JPEGs need cv2 or PIL.

    python -m mask_rcnn_tpu_torch.examples.voc.train [flags]
"""

import os

from mask_rcnn_tpu_torch.examples import train_common


def main(argv=None):
    from mask_rcnn_tpu_torch.data import SBDInstanceSegmentationDataset

    args = train_common.parse_args(dataset_defaults=dict(max_epoch=19.0),
                                   argv=argv)
    root = os.environ.get(
        "SBD_ROOT", "~/data/datasets/VOC/benchmark_RELEASE/dataset"
    )
    train_data = SBDInstanceSegmentationDataset("train", root=root)
    test_data = SBDInstanceSegmentationDataset("val", root=root)
    return train_common.train(
        args,
        train_data,
        test_data,
        class_names=train_data.class_names,
        dataset_kind="voc",
        min_size=600,
        max_size=1000,
        anchor_scales=(4, 8, 16, 32),
    )


if __name__ == "__main__":
    main()
