"""Serving speed of the port, the port of ``examples/coco/speedtest.py``
(the reference's examples/coco/speedtest.py): an R-50-C4 COCO model
(random weights from seed 0, or a log dir's), 5 warm-up requests, then the
mean time of ``--n-times`` batch-1 ``predict`` calls end to end (upload,
on-device resize, predict step, download, mask paste), or with
``--pipeline`` of ``predict_stream(depth=--depth)``, which overlaps the
host's prepare and paste of one image with the device's work on the next.

    python -m mask_rcnn_tpu_torch.examples.coco.speedtest [--n-times 10] \\
        [--log-dir DIR] [--image IMG] [--compute-dtype bfloat16] [--uint8] \\
        [--pipeline [--depth 2]] [--device cuda]

The image defaults to a 640x1066 random one (the 832x1344 bucket). The
clock is read after ``torch.cuda.synchronize()`` on a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    """Returns ``{"ms": mean ms an image, "hz": images a second,
    "pipeline": bool}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-times", type=int, default=10)
    parser.add_argument("--log-dir", default=None,
                        help="load weights from a log dir (else random)")
    parser.add_argument("--image", default=None)
    parser.add_argument(
        "--compute-dtype", choices=("float32", "bfloat16"),
        default="bfloat16",
    )
    parser.add_argument(
        "--uint8", action="store_true",
        help="ship uint8 pixels and normalize on device (4x less H2D)",
    )
    parser.add_argument(
        "--pipeline", action="store_true",
        help="predict_stream: overlap host prepare/paste and transfers "
        "with device compute of the next image",
    )
    parser.add_argument(
        "--depth", type=int, default=2,
        help="predict_stream in-flight depth",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to predict on ('cpu' runs every kernel's plain "
        "version)",
    )
    args = parser.parse_args(argv)

    import torch

    from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet

    if args.log_dir:
        from mask_rcnn_tpu_torch.examples.log_dir import (
            build_model_from_log_dir,
        )

        model, _ = build_model_from_log_dir(args.log_dir, device=args.device)
    else:
        model = MaskRCNNResNet(
            n_layers=50,
            n_fg_class=80,
            min_size=800,
            max_size=1333,
            anchor_scales=(2, 4, 8, 16, 32),
            compute_dtype=args.compute_dtype,
            device=args.device,
        )
    model.score_thresh = 0.7
    model.uint8_input = args.uint8

    if args.image:
        from mask_rcnn_tpu_torch.data._image import read_rgb

        img = read_rgb(args.image).transpose(2, 0, 1).astype(np.float32)
    else:
        rng = np.random.RandomState(0)
        img = rng.randint(0, 255, (3, 640, 1066)).astype(np.float32)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    for _ in range(5):
        model.predict([img])
    sync()
    t0 = time.perf_counter()
    if args.pipeline:
        for _ in model.predict_stream(
            ([img] for _ in range(args.n_times)), depth=args.depth
        ):
            pass
    else:
        for _ in range(args.n_times):
            model.predict([img])
    sync()
    dt = (time.perf_counter() - t0) / args.n_times
    what = "pipelined" if args.pipeline else "inference"
    print(f"Average {what} time: {dt * 1000:.3f} ms ({1 / dt:.2f} Hz)")
    return {"ms": dt * 1000, "hz": 1 / dt, "pipeline": args.pipeline}


if __name__ == "__main__":
    main()
