"""COCO minival evaluation (reference examples/coco/evaluate.py parity) of
a log dir that a train driver wrote. The root is ``$COCO_ROOT``.

    python -m mask_rcnn_tpu_torch.examples.coco.evaluate LOG_DIR [flags]
"""

import os

from mask_rcnn_tpu_torch.examples import evaluate_common


def main(argv=None):
    from mask_rcnn_tpu_torch.data import COCOInstanceSegmentationDataset

    test_data = COCOInstanceSegmentationDataset(
        "minival", root=os.environ.get("COCO_ROOT", "~/data/datasets/COCO"),
        use_crowd=True, return_crowd=True, return_area=True,
    )
    return evaluate_common.evaluate(
        test_data,
        class_names=test_data.class_names,
        dataset_kind="coco",
        indices_vis=list(range(9)),
        argv=argv,
    )


if __name__ == "__main__":
    main()
