"""Browse a dataset's ground truth in a cv2 window, the port of
``examples/view_dataset.py`` (the reference's datasets/view_dataset.py
flow): n = next, p = previous, q = quit.

    python -m mask_rcnn_tpu_torch.examples.view_dataset {coco,voc,sbd} \\
        [--split train]
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", choices=("coco", "voc", "sbd"))
    parser.add_argument("--split", default="train")
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.data import (
        COCOInstanceSegmentationDataset,
        SBDInstanceSegmentationDataset,
        VOC2012InstanceSegmentationDataset,
    )
    from mask_rcnn_tpu_torch.data.view_dataset import view_dataset

    ds = {
        "coco": COCOInstanceSegmentationDataset,
        "voc": VOC2012InstanceSegmentationDataset,
        "sbd": SBDInstanceSegmentationDataset,
    }[args.dataset](args.split)
    view_dataset(ds, class_names=ds.class_names)


if __name__ == "__main__":
    main()
