"""The custom-dataset drivers: ``train`` and ``evaluate`` over a directory
of ``img/*`` images, ``cls/*.npy`` and ``ins/*.npy`` label images and
``class_names.txt``."""

import argparse
import glob
import os.path as osp


def split_dataset_dir(argv):
    """(dataset, class names, the other arguments) for ``--dataset-dir``
    among ``argv``."""
    from mask_rcnn_tpu_torch.data import VOCLikeDataset

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--dataset-dir", required=True,
                        help="dir with img/*.jpg cls/*.npy ins/*.npy + "
                             "class_names.txt")
    known, rest = parser.parse_known_args(argv)
    root = known.dataset_dir
    imgs = sorted(glob.glob(osp.join(root, "img", "*")))
    cls = sorted(glob.glob(osp.join(root, "cls", "*.npy")))
    ins = sorted(glob.glob(osp.join(root, "ins", "*.npy")))
    with open(osp.join(root, "class_names.txt")) as f:
        class_names = [line.strip() for line in f if line.strip()]
    return VOCLikeDataset(imgs, cls, ins, class_names), class_names, rest
