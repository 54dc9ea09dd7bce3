"""Custom-dataset evaluation (reference examples/custom_dataset/evaluate.py
parity) of a log dir that the custom train driver wrote.

    python -m mask_rcnn_tpu_torch.examples.custom_dataset.evaluate \\
        LOG_DIR --dataset-dir DIR [flags]
"""

import sys

from mask_rcnn_tpu_torch.examples import evaluate_common
from mask_rcnn_tpu_torch.examples.custom_dataset import split_dataset_dir


def main(argv=None):
    dataset, class_names, rest = split_dataset_dir(
        sys.argv[1:] if argv is None else argv)
    return evaluate_common.evaluate(
        dataset, class_names=class_names, dataset_kind="voc",
        indices_vis=list(range(min(9, len(dataset)))),
        # match the training-time validation metric (train_common sets
        # use_07_metric for dataset_kind == 'voc'), so best_map in the log
        # and this eval_result are comparable numbers
        use_07_metric=True,
        argv=rest,
    )


if __name__ == "__main__":
    main()
