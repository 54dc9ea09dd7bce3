"""SBD val evaluation (reference examples/voc/evaluate.py parity) of a log
dir that a train driver wrote. The root is ``$SBD_ROOT``.

    python -m mask_rcnn_tpu_torch.examples.voc.evaluate LOG_DIR [flags]
"""

import os

from mask_rcnn_tpu_torch.examples import evaluate_common


def main(argv=None):
    from mask_rcnn_tpu_torch.data import SBDInstanceSegmentationDataset

    root = os.environ.get(
        "SBD_ROOT", "~/data/datasets/VOC/benchmark_RELEASE/dataset"
    )
    test_data = SBDInstanceSegmentationDataset("val", root=root)
    return evaluate_common.evaluate(
        test_data,
        class_names=test_data.class_names,
        dataset_kind="voc",
        indices_vis=list(range(9)),
        use_07_metric=True,
        argv=argv,
    )


if __name__ == "__main__":
    main()
