"""RoIAlign routes at the train-step shape, the port of
``examples/bench_align_variants.py``.

The train step samples a static 512 rois per image, contiguous by image.
This times the port's own RoIAlign routes on them, forward and
forward+backward: the grouped kernels K1 + K7 (rois (N, R, 4), the train
step's route), the flat kernels K4 + K13 (rois (R, 4) with image indices,
the head's ragged form), and the plain torch versions of both (the
separable-matrix einsums that the kernels replaced, in float32). It first
prints each route's largest difference from the flat route.

The JAX script's variants were settings of its einsum formulation. Where
the plain version has the setting, the row is kept: ``keep=short`` is the
plain grouped version itself (it contracts the longer spatial axis first),
and ``precision`` is torch's float32 matmul precision around the plain
einsums: HIGHEST = full float32, what the port runs
(``set_float32_precision``); DEFAULT = TF32. Dropped: ``keep=w`` (the plain
version picks its axis from the shape, with no setting) and the
``chunk128``/``chunk256`` rows (a hand kernel takes every roi in one
launch; the plain grouped version has no chunking), and the TPU's
"production" label: the grouped kernels are the train step's route.

    python -m mask_rcnn_tpu_torch.examples.bench_align_variants \\
        [--rois-per-image 512] [--batch 2] [--dtype bfloat16]

Columns: device ms (the union of device activity of a chained run),
CUDA-event ms of back-to-back calls, GFLOP, TFLOP/s on device time, GB.
Entry points run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import sys

import numpy as np
import torch

from mask_rcnn_tpu_torch.examples import _profile_common as common


@contextlib.contextmanager
def matmul_precision(precision):
    """torch's float32 matmul precision for the plain einsums: 'highest'
    (full float32) or 'default' (TF32 on the card)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def make_inputs(n, r, height, width, dtype, device):
    """The JAX script's inputs: (n, height/16, width/16, 1024) features and
    r rois per image of 30-130 px sides."""
    rng = np.random.RandomState(0)
    h, w, c = height // 16, width // 16, 1024
    feats = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).to(
        device).to(getattr(torch, dtype))
    y1 = rng.uniform(0, height - 140, (n, r))
    x1 = rng.uniform(0, width - 140, (n, r))
    rois_g = np.stack(
        [y1, x1, y1 + rng.uniform(30, 130, (n, r)),
         x1 + rng.uniform(30, 130, (n, r))], -1).astype(np.float32)
    rois_g = torch.from_numpy(rois_g).to(device)
    rois_f = rois_g.reshape(n * r, 4).contiguous()
    ridx = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int32), r)).to(
        device)
    return feats, rois_g, rois_f, ridx


def routes(rois_g, rois_f, ridx):
    """{name: feats -> (R, 7, 7, C)} of the port's RoIAlign routes."""
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    args = (7, 1.0 / 16, 0, 2)

    def grouped(f):
        return ra.roi_align_grouped(f, rois_g, *args).reshape(
            -1, 7, 7, f.shape[-1])

    def flat(f):
        return ra.roi_align(f, rois_f, ridx, *args)

    def plain_grouped(f, precision="highest"):
        with matmul_precision(precision):
            return ra.roi_align_grouped_plain(f, rois_g, *args).reshape(
                -1, 7, 7, f.shape[-1])

    def plain_flat(f):
        with matmul_precision("highest"):
            return ra.roi_align_plain(f, rois_f, ridx, *args, roi_chunk=512)

    return {
        "flat K4/K13": flat,
        "grouped K1/K7": grouped,
        "plain flat (chunk512, HIGHEST)": plain_flat,
        "plain grouped keep=short HIGHEST": plain_grouped,
        "plain grouped keep=short DEFAULT (TF32)": functools.partial(
            plain_grouped, precision="default"),
    }


def run(n=2, r=512, height=832, width=1344, dtype="bfloat16", iters=4,
        reps=8, device="cuda"):
    """Prints the comparison and the table; returns the rows."""
    line, peaks = common.card(device)
    feats, rois_g, rois_f, ridx = make_inputs(n, r, height, width, dtype,
                                              device)
    fns = routes(rois_g, rois_f, ridx)
    ref = fns["flat K4/K13"](feats).float()
    for name, fn in fns.items():
        if name != "flat K4/K13":
            err = (fn(feats).float() - ref).abs().max().item()
            print(f"{name}: max|diff| vs flat K4 = {err:.3e}")

    h, w = height // 16, width // 16
    print(f"\nRoIAlign routes: n={n} feat {h}x{w}x1024 rois/img={r} "
          f"{dtype}; {line}")
    print(common.CONVENTIONS)
    print(f"{'variant':44s} {'device ms':>10s} {'events ms':>10s} "
          f"{'GFLOP':>9s} {'TFLOP/s':>8s} {'GB':>8s}")
    rows = []
    for name, fn in fns.items():
        for label, build in ((name, fn),
                             (f"{name} fwd+bwd", common.fwd_bwd(fn))):
            row = common.measure(label, build, feats, reps, iters)
            tf = common.rates(row, peaks)[0]
            print(f"{label:44s} {row['device_ms']:10.3f} "
                  f"{row['events_ms']:10.3f} {row['flops'] / 1e9:9.2f} "
                  f"{tf:8.2f} {row['bytes'] / 1e9:8.3f}", flush=True)
            rows.append(row)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rois-per-image", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--height", type=int, default=832)
    parser.add_argument("--width", type=int, default=1344)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=4)
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.batch, args.rois_per_image, args.height, args.width, args.dtype,
        args.iters, args.reps, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
