"""Detectron e2e_mask_rcnn_R-50-C4_1x weights -> a log dir, the port of
``examples/coco/convert_caffe2.py`` (the reference's
examples/coco/convert_caffe2_to_chainer.py): ``snapshot_model.npz`` (the
JAX package's npz layout) and ``params.yaml`` with the COCO
``model_config``, which the demo, evaluate and speedtest drivers rebuild.

    python -m mask_rcnn_tpu_torch.examples.coco.convert_caffe2 \\
        model_final.pkl [--out logs/R-50-C4_x1_caffe2]

Nothing is fetched: the pkl must be on disk (the reference downloads it
from https://dl.fbaipublicfiles.com/detectron/35858828/.../model_final.pkl).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def main(argv=None):
    """Returns the output directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("pkl_path", help="Detectron model_final.pkl")
    parser.add_argument("--out", default="logs/R-50-C4_x1_caffe2")
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.utils.checkpoint import (
        flatten_params,
        params_from_numpy,
        save_params,
    )
    from mask_rcnn_tpu_torch.utils.detectron_import import (
        DETECTRON_MEAN,
        import_detectron_pkl,
    )
    from mask_rcnn_tpu_torch.utils.logging import dump_params

    # numpy, in the JAX package's layout
    flat = flatten_params(import_detectron_pkl(args.pkl_path, n_fg_class=80))
    vals = np.concatenate([v.ravel() for v in flat.values()])
    print(
        f"{len(flat)} tensors, {vals.size} params, "
        f"min={vals.min():.4f} mean={vals.mean():.4f} max={vals.max():.4f}"
    )

    os.makedirs(args.out, exist_ok=True)
    save_params(osp.join(args.out, "snapshot_model.npz"),
                params_from_numpy(flat))
    dump_params(
        args.out,
        {
            "dataset": "coco",
            "model": "resnet50",
            "model_config": dict(
                n_fg_class=80,
                n_layers=50,
                min_size=800,
                max_size=1333,
                anchor_scales=[2, 4, 8, 16, 32],
                roi_size=14,
                mean=list(DETECTRON_MEAN),
                pooling="align",
            ),
            "pretrained_from": args.pkl_path,
        },
    )
    print(f"-> {args.out}/snapshot_model.npz")
    return args.out


if __name__ == "__main__":
    main()
