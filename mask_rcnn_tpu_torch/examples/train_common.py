"""Shared training CLI, the port of ``examples/train_common.py`` (the
reference's examples/train_common.py).

The same flags: --model {resnet50,resnet101}, --pooling-func
{pooling,align,resize}, --roi-size, --initializer, --pretrained-model,
--max-epoch, --batch-size-per-gpu, --lr, --seed, --max-boxes, --logs-dir,
--eval-interval-epochs, --max-eval-examples, --compute-dtype, --min-size,
--max-size, --multi-node, --pool-detections, --resume,
--checkpoint-interval, --clip-norm, --remat, --input-uint8; plus --device
(default ``cuda``). --multi-node runs one process per device under
``torchrun --nproc-per-node N`` (``parallel/mesh.py::init_distributed``:
``cuda:{LOCAL_RANK}``, NCCL; gloo on the CPU): each rank's loader takes its
slice of every global batch of ``N * --batch-size-per-gpu`` images, and
--pool-detections pools the ranks' evaluation records. No visualization
report is written yet (``VisReport`` draws with cv2; it comes in a later
slice).
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(dataset_defaults: dict, argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "--model", choices=("resnet50", "resnet101"), default="resnet50"
    )
    parser.add_argument(
        "--pooling-func", choices=("pooling", "align", "resize"),
        default="align",
    )
    parser.add_argument("--roi-size", type=int, default=14)
    parser.add_argument(
        "--initializer", choices=("normal", "he_normal"),
        default="normal",
        help="mask-branch initializer (reference train_common.py:146-156)",
    )
    parser.add_argument(
        "--pretrained-model", default=None,
        help="'auto' / 'auto:<imagenet npz>' / 'imagenet:<npz>' / "
        "'<detectron>.pkl' / 'chainer:<snapshot npz>' / snapshot npz "
        "(reference default is 'auto'; the ImageNet npz must be on disk: "
        "nothing is downloaded)",
    )
    parser.add_argument(
        "--max-epoch", type=float,
        default=dataset_defaults.get("max_epoch", (180e3 * 8) / 118287),
    )
    parser.add_argument("--batch-size-per-gpu", type=int, default=1)
    parser.add_argument("--lr", type=float, default=None,
                        help="default: 0.00125 * global batch size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-boxes", type=int, default=64)
    parser.add_argument("--logs-dir", default="logs")
    parser.add_argument("--eval-interval-epochs", type=float, default=1.0)
    parser.add_argument("--max-eval-examples", type=int, default=None)
    parser.add_argument(
        "--compute-dtype", choices=("float32", "bfloat16"),
        default="float32",
    )
    parser.add_argument(
        "--min-size", type=int, default=None,
        help="override the dataset's resize min side (default: the "
        "dataset-specific reference value, e.g. 800 for COCO)",
    )
    parser.add_argument(
        "--max-size", type=int, default=None,
        help="override the dataset's resize max side (default: the "
        "dataset-specific reference value, e.g. 1333 for COCO)",
    )
    parser.add_argument(
        "--multi-node", action="store_true",
        help="data-parallel training, one process per device: run under "
        "`torchrun --nproc-per-node N` (device cuda:{LOCAL_RANK}, NCCL; "
        "gloo with --device cpu)",
    )
    parser.add_argument(
        "--pool-detections", action="store_true",
        help="multi-process eval: gather every rank's compact match records "
        "and score them together (the exact global mAP) instead of "
        "averaging the ranks' reports",
    )
    parser.add_argument(
        "--resume", default=None,
        help="train_state checkpoint dir to resume from",
    )
    parser.add_argument(
        "--checkpoint-interval", type=int, default=None,
        help="save full train_state every N steps (enables --resume)",
    )
    parser.add_argument(
        "--clip-norm", type=float, default=None,
        help="global gradient-norm clip (off = reference parity)",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="rematerialize backbone stages (larger per-device batches)",
    )
    parser.add_argument(
        "--input-uint8", action="store_true",
        help="ship uint8 images and mean-subtract on device (4x less "
        "host->device traffic; resize rounds to uint8 — off = strict "
        "reference parity)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to train on ('cpu' runs every kernel's plain "
        "version)",
    )
    return parser.parse_args(argv)


def train(args, train_data, test_data, class_names, dataset_kind,
          min_size, max_size, anchor_scales):
    from mask_rcnn_tpu_torch.parallel.mesh import (
        init_distributed,
        process_count,
        process_index,
    )

    device = args.device
    if args.multi_node:
        device = init_distributed(device=args.device)

    from mask_rcnn_tpu_torch.data import MaskRCNNTransform, TrainLoader
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
    )
    from mask_rcnn_tpu_torch.engine.loop import train as run_train
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    from mask_rcnn_tpu_torch.utils.logging import timestamp_dir

    if args.min_size is not None:
        min_size = args.min_size
    if args.max_size is not None:
        max_size = args.max_size
    cfg = MaskRCNNConfig(
        n_fg_class=len(class_names),
        n_layers=50 if args.model == "resnet50" else 101,
        min_size=min_size,
        max_size=max_size,
        anchor_scales=tuple(float(s) for s in anchor_scales),
        roi_size=args.roi_size,
        pooling=args.pooling_func,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
    )
    transform = MaskRCNNTransform(
        min_size, max_size, cfg.mean, train=True,
        rng=np.random.RandomState(args.seed),
        keep_uint8=args.input_uint8,
    )
    loader = TrainLoader(
        train_data,
        transform,
        batch_size=args.batch_size_per_gpu,  # one device a process
        max_boxes=args.max_boxes,
        min_size=min_size,
        max_size=max_size,
        seed=args.seed,
        process_index=process_index(),
        process_count=process_count(),
    )
    evaluator = InstanceSegmentationEvaluator(
        test_data, class_names, kind=dataset_kind,
        # reference trains VOC with the 11-point 2007 AP
        # (train_common.py:253-257)
        use_07_metric=(dataset_kind == "voc"),
        max_examples=args.max_eval_examples,
        pool_detections=args.pool_detections,
    )
    out_dir = [timestamp_dir(args.logs_dir) if process_index() == 0
               else None]
    if process_count() > 1:
        # each rank's clock may name another directory: take rank 0's
        import torch.distributed as dist

        dist.broadcast_object_list(out_dir, src=0)
    out_dir = out_dir[0]
    print(f"logs -> {out_dir}")
    print("visualization (VisReport) comes in a later slice of the port: "
          "no visualizations are written")
    result = run_train(
        cfg,
        loader,
        out_dir,
        max_epoch=args.max_epoch,
        batch_size_per_device=args.batch_size_per_gpu,
        evaluator=evaluator,
        eval_interval_epochs=args.eval_interval_epochs,
        seed=args.seed,
        lr=args.lr,
        resume_from=args.resume,
        checkpoint_interval_steps=args.checkpoint_interval,
        clip_norm=args.clip_norm,
        initializer=args.initializer,
        pretrained_model=args.pretrained_model,
        extra_params={
            "dataset": dataset_kind,
            "model": args.model,
            "pooling_func": args.pooling_func,
            "roi_size": args.roi_size,
            "initializer": args.initializer,
            "pretrained_model": args.pretrained_model,
        },
        device=device,
    )
    result["log_dir"] = out_dir
    print(result)
    return result
