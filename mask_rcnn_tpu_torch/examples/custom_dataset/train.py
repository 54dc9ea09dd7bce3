"""Bring-your-own-dataset training (reference examples/custom_dataset/
train.py parity): a directory of images + labelme-exported npy
class/instance label images, repeated to form a usable epoch.

    python -m mask_rcnn_tpu_torch.examples.custom_dataset.train \\
        --dataset-dir DIR [flags]
"""

import sys

from mask_rcnn_tpu_torch.examples import train_common
from mask_rcnn_tpu_torch.examples.custom_dataset import split_dataset_dir


class RepeatedDataset:
    def __init__(self, dataset, repeats):
        self.dataset = dataset
        self.repeats = repeats

    def __len__(self):
        return len(self.dataset) * self.repeats

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def main(argv=None):
    dataset, class_names, rest = split_dataset_dir(
        sys.argv[1:] if argv is None else argv)
    train_data = RepeatedDataset(dataset, 20)
    args = train_common.parse_args(dataset_defaults=dict(max_epoch=2.0),
                                   argv=rest)
    return train_common.train(
        args,
        train_data,
        dataset,
        class_names=class_names,
        dataset_kind="voc",
        min_size=600,
        max_size=1000,
        anchor_scales=(4, 8, 16, 32),
    )


if __name__ == "__main__":
    main()
