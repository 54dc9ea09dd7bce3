"""What the four profiling tools share (``mfu_report``, ``train_profile``,
``head_profile``, ``bench_align_variants``): the card's header and peaks,
the bench configuration, the fwd+bwd fold, and one measured row: device ms
(``utils/profiling.py::time_fn_chained``), CUDA-event ms of back-to-back
calls (``time_fn``), and FLOPs and bytes (``cost_of``, the hand kernels'
reports included), with the kernels that the row launched."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from mask_rcnn_tpu_torch.ops import costs
from mask_rcnn_tpu_torch.utils.profiling import (
    cost_of,
    time_fn,
    time_fn_chained,
)

CONVENTIONS = (
    "FLOPs: torch's FlopCounterMode (matmuls and convolutions, padded "
    "border taps counted; XLA leaves them out) plus the hand kernels' "
    "reports; bytes: every aten op's operands and results plus the "
    "kernels' inputs and outputs (high, like XLA's 'bytes accessed')")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"
    return res.stdout.strip().splitlines()[0]


def card(device):
    """(header line, peaks or None) of the tools' ``device``: a CUDA card's
    name and power limit and its peaks (``ops/costs.py::CARDS``; nan MFU
    for a card that is not there), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "device cpu (no card: no peaks, MFU nan)", None
    name = torch.cuda.get_device_name(device)
    peaks = costs.CARDS.get(name)
    line = f"card {nvidia_smi()}"
    if peaks is None:
        line += f" ({name}: not in the peak table, MFU nan)"
    else:
        line += (f" (peaks {peaks['flops']['bf16'] / 1e12:.0f} TFLOP/s "
                 f"bf16, {peaks['flops']['f32'] / 1e12:.0f} float32, "
                 f"{peaks['bytes_per_s'] / 1e9:.0f} GB/s)")
    return line, peaks


def bench_config(dtype, layers=50, **overrides):
    """``bench.py``'s COCO configuration: R-50/101-C4, 80 classes, anchor
    scales 2-32, 800 / 1333."""
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig

    kw = dict(n_fg_class=80, n_layers=layers, min_size=800, max_size=1333,
              anchor_scales=(2.0, 4.0, 8.0, 16.0, 32.0), compute_dtype=dtype)
    kw.update(overrides)
    return MaskRCNNConfig(**kw)


def kernel_wrappers():
    """{name: wrapper} of every hand kernel; each wrapper counts its
    launches in ``.launches`` and reports its work under its name."""
    from mask_rcnn_tpu_torch.models import resnet
    from mask_rcnn_tpu_torch.ops import nms, roi_align, targets

    fns = (resnet.stem_forward, roi_align.roi_align_grouped,
           roi_align.roi_align_grouped_backward, roi_align.roi_align,
           roi_align.roi_align_backward, roi_align.crop_and_resize,
           roi_align.crop_and_resize_backward, roi_align.roi_pool,
           roi_align.roi_pool_backward, nms.nms_blocked, nms.nms_small,
           nms.decode_select, targets.anchor_targets,
           targets.proposal_targets)
    return {fn.__name__: fn for fn in fns}


def launch_counts():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def grad_sum(grads):
    """Every gradient leaf folded into one float32 scalar, so the chained
    scalar depends on the whole backward."""
    return sum(g.float().sum() for g in grads if g is not None)


def fwd_bwd(fn):
    """``x -> fn(x)``'s float32 sum plus the sum of its gradient in x: the
    JAX tools' ``value_and_grad`` fold (only the feed's gradient)."""

    def wrapped(x):
        x = x.detach().requires_grad_(True)
        val = fn(x).float().sum()
        (grad,) = torch.autograd.grad(val, x)
        return val.detach() + grad.float().sum()

    return wrapped


def measure(name, build, feed, reps, iters, chained=None):
    """One row: ``build`` chained on ``feed`` (device ms), back to back
    (events ms: the host-paced time), and counted once (FLOPs, bytes, the
    kernels' reports and launches). ``chained`` replaces the device-ms
    measurement (the train steps)."""
    if chained is None:
        dev_ms = time_fn_chained(build, feed, reps=reps, iters=iters)
    else:
        dev_ms = chained()
    ev_ms = time_fn(build, feed, iters=iters, warmup=1)
    before = launch_counts()
    kernels = {}
    flops, n_bytes = cost_of(build, feed, kernels=kernels)
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    return {"name": name, "device_ms": dev_ms, "events_ms": ev_ms,
            "flops": flops, "bytes": n_bytes, "kernels": kernels,
            "launched": launched}


def rates(row, peaks, kind="bf16"):
    """(TFLOP/s on device time, MFU against the bf16 peak, roofline floor
    ms at the ``kind`` peak, its bound)."""
    tf = row["flops"] / (row["device_ms"] / 1e3) / 1e12
    mfu = (tf * 1e12 / peaks["flops"]["bf16"] if peaks is not None
           else float("nan"))
    floor, bound = costs.roofline(row["flops"], row["bytes"], peaks, kind)
    return tf, mfu, floor, bound


def check_rows(rows):
    """Every row finite with positive times, and every kernel a row launched
    reported work; raises otherwise."""
    for row in rows:
        for key in ("device_ms", "events_ms", "flops", "bytes"):
            if not np.isfinite(row[key]) or (key.endswith("ms")
                                             and row[key] <= 0):
                raise AssertionError(f"{row['name']}: {key} = {row[key]}")
        for k in row["launched"]:
            flops, n_bytes = row["kernels"].get(k, (0, 0, 0))[:2]
            if flops <= 0 and n_bytes <= 0:
                raise AssertionError(f"{row['name']}: kernel {k} launched "
                                     "but reported no work")
