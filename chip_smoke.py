#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mask_rcnn_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OTHER_CHECKOUT

1. builds the hand-written CUDA kernels from ``mask_rcnn_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. holds each kernel against its plain torch version on the card at the
   main paths' shapes and times both with CUDA events: RoIAlign K1 on
   (1, 52, 84, 1024) bf16 features with 1000 and 100 rois; proposal NMS K2
   6000 -> 1000 at 0.7 and, at the train counts, (2, 12000) -> 2000;
   the standalone decode NMS K3 80 x 256 -> 100 at 0.5; the decode's
   selection, K3 on the serving path (``decode_select``: per-class top-256,
   NMS at 0.5, zero-area drop and top 100 in one launch) at Rp = 1000 and
   81 classes, batch 1 and 2, score_thresh 0.05 and 0, bit for bit, with
   the kernels of one whole ``decode`` call from the profiler (no sort);
   RoIAlign
   backward K7 from (2, 512, 7, 7, 1024) bf16 to (2, 52, 84, 1024); the
   target creators, each one launch: K9a ``anchor_targets`` on 2 x 65520
   anchors and 8 gts per image, and K9b ``proposal_targets`` (with the
   mask-target crop-resize K8) on (2, 2008) candidates and (2, 8, 832, 168)
   packed masks to 512 slots of (14, 14), under drawn and under tied
   sampling priorities (labels, rois and masks identical, locs within
   1e-6); the alternate
   poolers' crop-and-resize K5 and max RoI pooling K6 (identical) on the
   same features with 1000 and 100 flat rois to 14x14 bins, with K5's
   logical tap reads, the card's write floor (``zero_()`` of a tensor of
   K5's output, a yardstick the port never calls) and K5 on its stores
   alone (every roi index out of range: zeros, no reads) beside K5's time,
   K6 also on features holding NaN and +-inf (a bin with a NaN or +inf
   pools to 0),
   and their backwards K11 and K12 from (1024, 14, 14, 1024) bf16 to
   (2, 52, 84, 1024), K11 also from the gradient res5's stride-2 convs send
   (zero on every odd py or odd px), K12 also on rois inside a block of
   exact zeros (every position of a bin ties);
3. checks the whole predict step, and the whole train step (losses and
   gradients, with the same sampling priorities), on the GPU against the
   plain path on the CPU at small float32 inputs, under each RoI pooler
   (``pooling`` = ``align``, ``resize``, ``pooling``);
4. serving path, once per pooler: drives ``MaskRCNNResNet.predict`` at
   R-50-C4, COCO (80 classes), anchor scales (2, 4, 8, 16, 32), min 800 /
   max 1333 (buckets 832x1344 and 1344x832), bf16, seeded random weights:
   single images, a batch of two, and a request at ``score_thresh=0``;
   checks the outputs and that K10, the pooler's forward kernel (K1, K5 or
   K6), K2 and the decode's K3 (``decode_select``) were launched during
   that run; then profiles two batch-1 requests by kernel family;
5. training path, once per pooler: ``make_train_step`` at the same
   configuration, bf16 compute with float32 master params, on a synthetic
   batch of 2 at the 832x1344 bucket with 8 gts per image and bit-packed
   masks: 3 warm-up and 10 (``align``) or 5 timed steps; checks that every
   loss is finite, that the frozen params did not change and every
   trainable one did, and that the stem K10, the pooler's kernels (K1/K7,
   K5/K11 or K6/K12), K2, K9a and K9b were launched during that run; the
   align run then times the step with the four-op stem swapped in, and K2
   against its plain version on the boxes that the step's RPN hands it
   (identical, with where the scan stopped); then profiles two more steps
   (the serving path checks K10 too);
6. flat head path: ``head_forward`` on flat rois with image indices (R-50
   res5, 80 classes, bf16, a 1300/700 split over a 2-image 832x1344 batch),
   forward and backward; checks that K4 and K13 were launched, then the
   flat head against the grouped one at equal counts;
7. train loop: ``engine/loop.py::train`` at the train path's
   configuration on 16 in-memory 480x640 images (8 steps an epoch) with
   COCO evaluation on 4 more, a checkpoint, evaluation and a log entry
   every 4 steps; run A stops at step 4, run B resumes from its checkpoint
   (restored bit for bit) to step 8; checks the artifacts, finite losses
   and that K10, K1, K2, K3 (``decode_select``), K7, K9a and K9b were
   launched;
8. entry points from disk, at the same configuration in a temporary
   directory: a seeded Detectron pkl of the COCO shapes, the bridge npz of
   its tree and its chainer snapshot give identical params and
   bit-identical bf16 predictions; 'auto' (through
   $MASK_RCNN_TPU_IMAGENET_NPZ) gives the params of 'imagenet:<npz>' on a
   seeded chainer ImageNet npz; the COCO train driver
   (``mask_rcnn_tpu_torch.examples.coco.train.main``) runs 8 steps at its
   defaults (batch 1, float32, ``--pretrained-model auto``) with one
   evaluation on the port's synthetic PNG root (480x640), and the evaluate
   driver rebuilds the model from the log dir and prints its COCO numbers;
   with a JPEG codec (cv2 or PIL) the VOC/SBD drivers run too, on the
   port's SBD root; checks finite losses, the log dirs and that K10, K1,
   K2, K3, K7, K9a and K9b were launched; prints import seconds per spec,
   driver ms per step, evaluation s per image and the JPEG decoder found;
9. data parallelism, in ranks that ``parallel/dryrun.py::launch`` starts
   (this process holds no group): (i) NCCL at world size 1, the float32
   data-parallel step against the plain one; (ii) two gloo ranks sharing
   ``cuda:0`` at the train path's configuration, batch 1 each, 3 float32
   and 3 bf16 steps against this process's b2 steps on the same
   priorities (step 1's losses and every leaf's update: float32 within
   2e-3, bf16 within 5e-3 and 2e-2, with two more plain bf16 steps read
   against the first and a control, each rank dividing by its own counts
   with the gradients averaged, that must miss the bf16 limits),
   identical params on both ranks, the all-reduce timed alone, and K10,
   K1, K2, K7, K9a and K9b launched in every rank; (iii) ``train()`` on
   the two ranks over phase 7's images: 2 steps and a checkpoint, a
   resume to step 4, and a pooled COCO evaluation (score threshold 0)
   whose match records and report equal this process's evaluation of the
   same snapshot; K3 launched too;
10. the user's last mile, in this process: (a) phase 8's drivers write
   their visualization report (3 x 3 panels of (h, 2w) that decode, the
   seconds it adds to an evaluation); (b) ``examples/demo.py`` from a log
   dir of the seeded weights (score threshold 0, a PNG of each
   orientation and a JPEG where a codec imports: numbered outputs of each
   input's size, each unlike its input), beside a log dir that
   ``examples/coco/convert_caffe2.py`` writes from a seeded Detectron pkl;
   (c) ``examples/coco/speedtest.py`` at its defaults, 20 requests, plain
   and ``--pipeline``; (d) ``examples/summarize_logs.py``, a row for each
   log dir; K10, K1, K2 and K3 launched in (b)-(d); (e)
   ``examples/check_train_overfit.py``'s function at its own
   configuration, 400 steps: finite losses, the last at most 0.75 of the
   first; K10, K1, K2, K3, K7, K9a and K9b launched;
11. the profiling layer and the last two checks, in this process: (a)
   ``utils/profiling.py::time_fn_chained`` on K1 (1000 rois) and K2 (6000
   -> 1000) within 25% of the profiler's device time of the same call and
   of phase 2's CUDA-event time, each from one profiler capture that
   must hold every launch's device activity (a short capture fails the
   phase), and ``time_train_steps_chained`` on the align b2 bf16 step
   beside phase 5's times; (b) ``mfu_report`` (R-50), ``train_profile``
   (bf16 and float32), ``head_profile`` and ``bench_align_variants`` at
   their default shapes
   (timing depth cut): finite rows, every launched kernel's cost reported,
   K1, K2, K3, K4, K7, K9a, K9b, K10 and K13 launched (counted in
   ``launches`` only); (c) ``check_eval_memory`` at ``--images 200 --raw``
   and ``--images 50``, RSS bounded; (d) ``check_dtype_parity`` at its tiny
   settings on the card, its rehearsals and their drivers run in this
   process;
12. the port's headline benchmark, ``python -m mask_rcnn_tpu_torch.bench``
   (``main([])``) in this process: its JSON line printed beside the card's
   name and power limit, every number finite and above 0, ``0 < mfu <
   1.05``, ``batch`` 2, ``dtype`` bfloat16, ``image_hw`` [832, 1344]; K1,
   K2, K3, K7, K9a, K9b and K10 launched (counted in ``launches`` only).

Prints the card's name and power limit, each path's times, one JSON line
of kernel results (``launches`` over every main-path run above,
``launches_main`` over the default configuration's: the ``align`` serving
and train runs, the train loop, the entry points, summed over the ranks
the data-parallel bf16 steps and ``train()``, and the last mile), and as
its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, when a phase fails or no CUDA device
is present.

With ``--against OTHER_CHECKOUT`` it runs none of the above: it times K1,
K2, K4, K7, K13, K10, the two target creators, ``decode`` at the serving
shape, K12, K6, K11, K5 (bf16 at 1000 and 100 rois, float32 at 1000), the
align ``predict_step`` at batch 1 and the align train step of this
checkout against another checkout's on the same inputs (see
:func:`run_against`).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_CLASS_FG = 80
POOLERS = ("align", "resize", "pooling")  # MaskRCNNConfig.pooling


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup=3, iters=20):
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(torch, fn, iters=10):
    """(name, device activities, device ms) per call of ``fn`` for each
    kernel, memset and copy that it runs, from the profiler over ``iters``
    calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.count / iters, ev.self_device_time_total / 1e3 / iters)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def device_profile(torch, fn, iters=10):
    """Device time and device activities (kernels, memsets, copies) per
    call of ``fn`` (:func:`device_events`). Unlike :func:`cuda_ms` the time
    leaves out the gaps in which the device waits for the host, so it reads
    a kernel whose wrapper's host work takes longer than the kernel."""
    events = device_events(torch, fn, iters)
    return (sum(ev[2] for ev in events), sum(ev[1] for ev in events))


def families(events):
    """{kernel family (:func:`kernel_group`): [device ms, device
    activities]} of :func:`device_events`' events."""
    groups = {}
    for name, cnt, ms in events:
        g = groups.setdefault(kernel_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    return groups


def print_families(groups, what):
    total = sum(v[0] for v in groups.values())
    count = sum(v[1] for v in groups.values())
    print(f"profile of {what}, device time by kernel family (ms, device "
          f"activities): total {total:.3f} ms, {count:g} activities")
    for name, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:30s} {ms:9.3f} {cnt:8g}")


def device_ms(torch, fn, iters=10):
    """Device time per call (:func:`device_profile`)."""
    return device_profile(torch, fn, iters)[0]


# The least time the card could take (``bound``), and the work formulas
# behind it, come from the port's one home of them, ``ops/costs.py``: bytes
# at the H100's 3.35 TB/s, operations at the published peak for their type
# (bf16 989 TFLOP/s on the tensor cores, float32 67 TFLOP/s on the CUDA
# cores), whichever is larger. Imported inside the functions: an A/B
# worker imports its own checkout's package.


def bound(n_bytes, flops, peak="f32"):
    """The kernel line's bound keys; no single torch call computes any of
    these functions (torchvision is not installed), so library_ms is
    null."""
    from mask_rcnn_tpu_torch.ops.costs import HBM_BYTES_PER_S, PEAK_FLOPS

    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def align_bwd_atomics(rois, feat_hw, p=7, s=2, scale=1 / 16):
    """The float32 atomics a RoIAlign backward issues per channel for these
    rois, counted from their sample taps: four per kept sample (one per tap,
    as the earlier one-thread-per-channel K7 issued them), and one per
    (roi, bin row, feature row, feature column) that the bin row's samples
    reach (the merge of the redesigned K7/K13: a thread sums what lands on
    one cell before its atomic); and, for a design that would merge a whole
    roi first, one per (roi, cell) that any of its samples reaches."""
    r = np.asarray(rois, np.float32).reshape(-1, 4) * np.float32(scale)
    n = len(r)
    ext = np.maximum(r[:, 2:] - r[:, :2], np.float32(1.0))
    bins = ext / np.float32(p * s)

    def taps(axis):  # (rois, p, grid) low and high taps, -1 where skipped
        size = feat_hw[axis]
        g = np.clip(np.ceil(bins[:, axis]), 1, -(-size // (p * s)))
        grid = np.arange(int(g.max()), dtype=np.float32)
        c = (r[:, axis, None, None]
             + (np.arange(p, dtype=np.float32) * s)[:, None]
             * bins[:, axis, None, None]
             + (grid + np.float32(0.5)) * (bins[:, axis] / g)[:, None, None])
        keep = (grid < g[:, None, None]) & (c >= -1) & (c <= size)
        low = np.minimum(np.floor(np.maximum(c, 0)), size - 1).astype(int)
        high = np.where(low >= size - 1, -1, low + 1)
        return np.where(keep, low, -1), np.where(keep, high, -1), keep

    def reached(low, high, size):  # distinct cells per leading index
        occ = np.zeros(low.shape[:-1] + (size + 1,), bool)
        lead = np.indices(low.shape)[:-1]
        occ[(*lead, low)] = True
        occ[(*lead, high)] = True
        return occ[..., :size].sum(-1)

    ylow, yhigh, ykeep = taps(0)
    xlow, xhigh, xkeep = taps(1)
    scatters = 4 * (ykeep.reshape(n, -1).sum(1)
                    * xkeep.reshape(n, -1).sum(1)).sum()
    rows = reached(ylow, yhigh, feat_hw[0])  # (rois, p)
    all_rows = reached(ylow.reshape(n, -1), yhigh.reshape(n, -1), feat_hw[0])
    cols = reached(xlow.reshape(n, -1), xhigh.reshape(n, -1), feat_hw[1])
    return (int(scatters), int((rows * cols[:, None]).sum()),
            int((all_rows * cols).sum()))


def scan_note(idx, mask, n, max_out):
    """Where K2's scan stopped, in candidates and tiles of 64."""
    from mask_rcnn_tpu_torch.ops import costs

    stops = costs.nms_stops(idx, mask, n, max_out)
    return (f"scan stopped after candidate {stops} "
            f"(tile {[-(-s // 64) for s in stops]} of {-(-n // 64)})")


def proposal_like_boxes(rng, n, h, w):
    """Clipped boxes of mixed sizes, clustered like proposals, some at the
    borders (float coordinates, not on a grid)."""
    k = max(n // 6, 1)
    cy, cx = rng.uniform(0, h, k), rng.uniform(0, w, k)
    bh = np.exp(rng.uniform(np.log(8), np.log(h), k))
    bw = bh * np.exp(rng.uniform(-1, 1, k))
    pick = rng.randint(0, k, n)
    jitter = rng.randn(n, 4) * 0.08
    cy = cy[pick] + jitter[:, 0] * bh[pick]
    cx = cx[pick] + jitter[:, 1] * bw[pick]
    hh = bh[pick] * np.exp(jitter[:, 2])
    ww = bw[pick] * np.exp(jitter[:, 3])
    boxes = np.stack([cy - hh / 2, cx - ww / 2, cy + hh / 2, cx + ww / 2], 1)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, h)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, w)
    return boxes.astype(np.float32)


def check_kernels(torch, results):
    """Phase 2: each kernel against its plain version at the path's shapes."""
    from mask_rcnn_tpu_torch.ops import costs, nms, roi_align

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    # K1: box pass (1000 rois) and mask pass (100 rois), bf16 features.
    feats = torch.from_numpy(
        rng.randn(1, 52, 84, 1024).astype(np.float32)).to(dev).bfloat16()
    k1 = {"name": "roi_align_grouped", "route": "cuda",
          "source": "mask_rcnn_tpu_torch/csrc/roi_align.cu",
          "replaces": "mask_rcnn_tpu/ops/roi_align.py:235",
          "max_abs_err": 0.0}
    # tolerance: one bf16 rounding of the float32 plain result
    rtol, atol = 2.0 ** -8, 1e-5
    for r in (1000, 100):
        boxes = proposal_like_boxes(rng, r, 832, 1344)
        boxes[-r // 20:] = 0.0  # zero-padded slots, as proposals have
        rois = torch.from_numpy(boxes[None]).to(dev)
        args = (7, 1 / 16, 0, 2)
        got = roi_align.roi_align_grouped(feats, rois, *args)
        want = roi_align.roi_align_grouped_plain(feats.float(), rois, *args)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        bad = (err > atol + rtol * want.abs()).sum().item()
        k1["max_abs_err"] = max(k1["max_abs_err"], err.max().item())
        ms = cuda_ms(torch, lambda: roi_align.roi_align_grouped(
            feats, rois, *args))
        plain_ms = cuda_ms(torch, lambda: roi_align.roi_align_grouped_plain(
            feats.float(), rois, *args), warmup=1, iters=3)
        samples = costs.align_samples(boxes, (52, 84))
        # logical tap bytes: four taps of every channel a sample, whether
        # they come from L1, L2 or memory
        taps = samples * 4 * 1024 * feats.element_size()
        print(f"K1 roi_align {r} rois: max|err| {err.max().item():.3e} "
              f"(rtol {rtol:g}, atol {atol:g}, {bad} outside), "
              f"kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms, "
              f"{taps / 1e6:.1f} MB of logical tap reads")
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{bad} values ({r} rois)")
        if r == 1000:  # the box pass's shape; the mask pass's is printed
            k1["ms"], k1["plain_ms"] = ms, plain_ms
            k1.update(bound(costs.nbytes(feats, rois, got),
                            8 * 1024 * samples))
    results["roi_align_grouped"] = k1

    # K2: 6000 score-sorted proposals -> 1000 at 0.7; a tail of invalid
    # (-inf score) rows like the top-k leaves.
    boxes = torch.from_numpy(
        proposal_like_boxes(rng, 6000, 832, 1344)[None]).to(dev)
    valid = torch.from_numpy(
        (rng.rand(1, 6000) > 0.02) & (np.arange(6000) < 5900)).to(dev)
    # K3: 80 classes x 256 sorted candidates -> 100 at 0.5.
    cboxes = torch.from_numpy(np.stack(
        [proposal_like_boxes(rng, 256, 640, 1066) for _ in range(80)])).to(dev)
    cvalid = torch.from_numpy(
        np.arange(256)[None] < rng.randint(0, 257, (80, 1))).to(dev)
    for name, fn, plain, b, v, t, k, line in (
        ("nms_blocked", nms.nms_blocked, nms.nms_blocked_plain, boxes, valid,
         0.7, 1000, 113),
        ("nms_small", nms.nms_small, nms.nms_small_plain, cboxes, cvalid,
         0.5, 100, 48),
    ):
        idx, mask = fn(b, v, t, k)
        want_idx, want_mask = plain(b, v, t, k)
        torch.cuda.synchronize()
        same = torch.equal(idx, want_idx) and torch.equal(mask, want_mask)
        n_diff = (idx != want_idx).sum().item()
        ms = cuda_ms(torch, lambda: fn(b, v, t, k))
        plain_ms = cuda_ms(torch, lambda: plain(b, v, t, k), warmup=1,
                           iters=3)
        scan = (", " + scan_note(want_idx, want_mask, b.shape[1], k)
                if name == "nms_blocked" else "")
        print(f"{'K2' if name == 'nms_blocked' else 'K3'} {name} "
              f"{tuple(b.shape)} -> {k}: identical={same} "
              f"(kept {int(mask.sum())}{scan}), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{n_diff} positions")
        results[name] = {
            "name": name, "route": "cuda",
            "source": "mask_rcnn_tpu_torch/csrc/nms.cu",
            "replaces": f"mask_rcnn_tpu/ops/nms.py:{line}",
            "max_abs_err": float(n_diff), "ms": ms, "plain_ms": plain_ms,
            **bound(costs.nbytes(b, v, idx, mask),
                    12 * costs.nms_pairs(idx, mask, b.shape[1], k)),
        }


SERVE_RP = 1000  # rois a served image hands the decode (n_test_post_nms)


def decode_arrays(rng, n, rp=SERVE_RP):
    """The decode's inputs at the serving shape, numpy: proposal-like rois
    of the 832x1344 bucket (the last 5% zero-padded and invalid, as
    proposals are), seeded locs and logits over 81 classes, original size
    640x1066 at scale 1.25."""
    rois = np.stack([proposal_like_boxes(rng, rp, *TRAIN_HW)
                     for _ in range(n)])
    valid = np.ones((n, rp), bool)
    valid[:, rp - rp // 20:] = False
    rois[~valid] = 0.0
    c = N_CLASS_FG + 1
    return (rois, valid,
            (rng.randn(n, rp, 4 * c) * 0.5).astype(np.float32),
            (rng.randn(n, rp, c) * 2).astype(np.float32),
            np.tile(np.float32([[640, 1066]]), (n, 1)),
            np.full(n, 1.25, np.float32))


def decode_work(torch, cls_bbox, prob, valid, thresh, k, nms_thresh, d):
    """What the decode's selection must do on these inputs: bytes (the
    foreground probabilities and the validity read once, the boxes of the
    rows it selects, at most k valid rows above the threshold a class,
    and d outputs an image) and IoU pairs (each kept box against the
    selected candidates after it, up to where the class's scan stops; 12
    float operations a pair), from the plain selection's own steps."""
    from mask_rcnn_tpu_torch.ops import costs

    n, rp, c = prob.shape
    pairs, selected = costs.decode_pairs(cls_bbox, prob, valid, thresh, k,
                                         nms_thresh, d)
    n_bytes = (n * rp * (c - 1) * 4 + valid.numel() + selected * 16
               + n * d * (16 + 4 + 4 + 1))
    return n_bytes, pairs


def check_decode_kernel(torch, results):
    """Phase 2, the decode's selection (K3 on the serving path): the kernel
    against its plain twin on the card at the serving shape (Rp = 1000, 81
    classes, seeded logits), batch 1 and 2, score_thresh 0.05 and 0: boxes,
    labels, scores and valid bit for bit; then the kernels of one whole
    ``decode`` call from the profiler, which must hold no sort."""
    from mask_rcnn_tpu_torch.models import mask_rcnn
    from mask_rcnn_tpu_torch.ops import nms

    rng = np.random.RandomState(SEED + 3)
    cfg = mask_rcnn.MaskRCNNConfig(n_fg_class=N_CLASS_FG)
    entry = {"name": "decode_select", "route": "cuda",
             "source": "mask_rcnn_tpu_torch/csrc/nms.cu",
             "replaces": "mask_rcnn_tpu/models/mask_rcnn.py:170",
             "max_abs_err": 0.0}
    for n in (1, 2):
        t = [torch.from_numpy(a).cuda() for a in decode_arrays(rng, n)]
        cls_bbox, prob = mask_rcnn.decode_boxes(cfg, t[0], *t[2:])
        for thresh in (0.05, 0.0):
            args = (cls_bbox, prob, t[1], thresh, cfg.nms_topk_per_class,
                    cfg.nms_thresh, cfg.detections_per_im)
            got = nms.decode_select(*args)
            want = nms.decode_select_plain(*args)
            torch.cuda.synchronize()
            n_diff = sum((g != w).sum().item() for g, w in zip(got, want))
            ms = cuda_ms(torch, lambda: nms.decode_select(*args))
            dev_ms, acts = device_profile(torch,
                                          lambda: nms.decode_select(*args))
            plain_ms = cuda_ms(torch, lambda: nms.decode_select_plain(*args),
                               warmup=1, iters=3)
            n_bytes, pairs = decode_work(torch, *args)
            b = bound(n_bytes, 12 * pairs)
            print(f"K3 decode_select N={n} Rp={SERVE_RP} 81 classes "
                  f"score_thresh={thresh}: identical={n_diff == 0} "
                  f"(detections {want[3].sum(1).tolist()}), kernel "
                  f"{ms:.4f} ms (device {dev_ms:.4f}, {acts:g} activities), "
                  f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
                  f"({b['bound_by']}: {n_bytes} bytes, {pairs} IoU pairs)")
            if n_diff:
                raise AssertionError(f"decode_select differs from its plain "
                                     f"twin at {n_diff} values (N={n}, "
                                     f"score_thresh={thresh})")
            if n == 1 and thresh == cfg.score_thresh:  # serving's default
                entry.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, **b)
    results["decode_select"] = entry

    # One whole decode (prologue + selection) at batch 1, from the profiler.
    before = nms.decode_select.launches
    events = device_events(torch, lambda: mask_rcnn.decode(
        cfg, t[0][:1], t[1][:1], *(x[:1] for x in t[2:])), iters=1)
    assert nms.decode_select.launches == before + 2  # warm-up + traced
    print("kernels of one decode call (device activities, ms):")
    for name, cnt, ms in events:
        print(f"  {cnt:4g} {ms:8.4f}  {name[:100]}")
    sorts = [e[0] for e in events
             if "sort" in e[0].lower() or "radix" in e[0].lower()]
    if sorts:
        raise AssertionError(f"a decode call ran sort kernels: {sorts}")


def check_small_reference(torch, pooling="align"):
    """Phase 3: the predict step on the GPU (kernels) against the plain path
    on the CPU, float32, at a small input."""
    from mask_rcnn_tpu_torch.models import mask_rcnn, rpn
    from mask_rcnn_tpu_torch.models.mask_rcnn import map_params

    cfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=3, min_size=64, max_size=96, anchor_scales=(1.0, 2.0),
        detections_per_im=8, pooling=pooling,
        proposal=rpn.ProposalConfig(n_test_pre_nms=80, n_test_post_nms=24),
    )
    params = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    args = (rng.randn(2, 64, 96, 3).astype(np.float32) * 10,
            np.array([[60.0, 90.0], [64.0, 96.0]], np.float32),
            np.array([1.0, 1.0], np.float32))
    with torch.no_grad():
        want = mask_rcnn.predict_step(params, cfg,
                                      *map(torch.from_numpy, args))
        got = mask_rcnn.predict_step(
            map_params(lambda t: t.cuda(), params), cfg,
            *(torch.from_numpy(a).cuda() for a in args))
    got = {k: v.cpu() for k, v in got.items()}
    assert want["valid"].any(), "small reference produced no detections"
    assert torch.equal(got["valid"], want["valid"]), "valid differs"
    assert torch.equal(got["labels"], want["labels"]), "labels differ"
    for k, atol in (("boxes", 1e-3), ("scores", 1e-5), ("mask_probs", 1e-4)):
        err = (got[k] - want[k]).abs().max().item()
        print(f"small f32 reference, pooling={pooling} (GPU vs CPU plain): "
              f"{k} max|err| {err:.3e} (atol {atol:g})")
        assert err <= atol, f"{k} differs from the CPU reference by {err}"


def require_launched(counts, path):
    """Fail unless every kernel of ``counts`` was launched on ``path``."""
    print(f"kernel launches during the {path}: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}")


def drive_main_path(torch, kernels, pooling="align"):
    """Phase 4: the port's serving path at full width with the RoI pooler
    ``pooling``; returns the launch counts of the run and the steady ms per
    image."""
    from mask_rcnn_tpu_torch import MaskRCNNResNet
    from mask_rcnn_tpu_torch.data.loader import bucket_shape

    t0 = time.perf_counter()
    model = MaskRCNNResNet(
        n_layers=50, n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
        anchor_scales=(2, 4, 8, 16, 32), pooling_func=pooling,
        compute_dtype="bfloat16", rng_seed=SEED, device="cuda",
    )
    print(f"model (pooling={pooling}) built in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)

    def image(h, w):
        return rng.uniform(0, 255, (3, h, w)).astype(np.float32)

    for wrapper in kernels:
        wrapper.launches = 0
    requests = [[image(640, 1066)], [image(1066, 640)],
                [image(427, 640), image(640, 480)]]
    if pooling == "align":
        requests.insert(1, [image(480, 640)])
    for imgs in requests:
        shapes = []
        for img in imgs:
            h, w = img.shape[1:]
            s = min(800 / min(h, w), 1333 / max(h, w))
            shapes.append(bucket_shape(round(h * s), round(w * s), 800, 1333))
        bboxes, masks, labels, scores = model.predict(imgs)
        check_outputs(imgs, bboxes, masks, labels, scores)
        print(f"request {[i.shape[1:] for i in imgs]} -> buckets {shapes} "
              f"(batch padded to the largest), detections "
              f"{[len(b) for b in bboxes]}")
    model.score_thresh = 0.0
    imgs = [image(640, 1066), image(1066, 640)]
    out = model.predict(imgs)
    check_outputs(imgs, *out)
    n_det = [len(b) for b in out[0]]
    print(f"score_thresh=0 request -> detections {n_det}")
    assert n_det == [100, 100], "expected 100 detections per image"
    counts = {w.__name__: w.launches for w in kernels}
    require_launched(counts, f"serving path (pooling={pooling})")

    # steady state at batch 1 (kernels keep counting; counts already read)
    model.score_thresh = 0.05
    one = [image(640, 1066)]
    for _ in range(3):
        model.predict(one)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        model.predict(one)
    ms_img = (time.perf_counter() - t0) * 1e3 / reps
    step_ms = cuda_ms(torch, lambda: model.predict_submit(one), warmup=2,
                      iters=reps)
    print(f"steady batch-1 predict, pooling={pooling} (640x1066 -> "
          f"832x1344 bucket, bf16): "
          f"{ms_img:.3f} ms/img end to end (host clock, synchronised), "
          f"{step_ms:.3f} ms/img prepare+predict_step (CUDA events)")
    print_families(families(device_events(torch, lambda: model.predict(one),
                                          iters=2)),
                   f"batch-1 predict, pooling={pooling} (per image)")
    return counts, ms_img, step_ms


TRAIN_HW = (832, 1344)


def train_batch(torch, n, h, w, device, **kw):
    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch

    batch = make_synthetic_train_batch(n, h, w, np.random.RandomState(SEED),
                                       **kw)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def anchor_target_bytes(a_in, got, cfg):
    """The bytes K9a's function must move on this run's data: the anchors,
    gt boxes and validity, one priority per sampling candidate (``pri_pos``
    of a pre-sampling positive, ``pri_neg`` of a negative), then loc and
    label. Returns (bytes, what was counted)."""
    from mask_rcnn_tpu_torch.ops import costs, targets

    bbox, valid, anchors, img_size = a_in
    _, label = targets.anchor_match_plain(
        anchors, bbox, valid, img_size, cfg.pos_iou_thresh,
        cfg.neg_iou_thresh)
    cand = (label >= 0).sum().item()
    return costs.nbytes(bbox, valid, anchors, *got) + 4 * cand, {
        "candidate priorities": cand}


def proposal_target_bytes(torch, p_in, got, cfg):
    """The bytes K9b + K8's function must move on this run's data: the rois,
    gt boxes, labels and validity, one priority per sampling candidate, the
    outputs, and of the packed (N, G, H, W/8) masks only the distinct bytes
    that the positive crops' bilinear taps read. Returns (bytes, what was
    counted)."""
    from mask_rcnn_tpu_torch.ops import costs, targets

    roi, roi_valid, bbox, _, valid, masks = p_in
    thresh = (cfg.pos_iou_thresh, cfg.neg_iou_thresh_hi,
              cfg.neg_iou_thresh_lo)
    _, pos, neg = targets.proposal_match_plain(
        torch.cat([roi, bbox], 1), torch.cat([roi_valid, valid], 1), bbox,
        valid, *thresh)
    cand = (pos | neg).sum().item()
    sample_roi, _, gt_label = got[:3]
    n_crop = min(int(round(cfg.n_sample * cfg.pos_ratio)), cfg.n_sample)
    crop_roi = sample_roi[:, :n_crop]
    positive = gt_label[:, :n_crop] > 0
    # a sampled box's gt is its own argmax, as it was the candidate's
    gt_of, _, _ = targets.proposal_match_plain(
        crop_roi, torch.ones_like(positive), bbox, valid, *thresh)
    n, g, hm, wm = masks.shape
    y0, y1, x0, x1, _, _ = targets.mask_sample_coords(
        crop_roi, (hm, wm * 8), cfg.mask_size)
    image = torch.arange(n, device=roi.device)[:, None]
    row = ((image * g + gt_of) * hm)[..., None]
    taps = [((row + y)[..., :, None] * wm + (x // 8)[..., None, :])[positive]
            for y in (y0, y1) for x in (x0, x1)]
    mask_bytes = torch.unique(torch.cat(taps)).numel()
    n_bytes = (costs.nbytes(roi, roi_valid, *p_in[2:5], *got) + 4 * cand
               + mask_bytes)
    return n_bytes, {"candidate priorities": cand,
                     "crops": positive.sum().item(),
                     "distinct mask bytes": mask_bytes}


def check_train_kernels(torch, results):
    """Phase 2, training side: K7, K2 at the train counts, K9a and K9b + K8
    against their plain versions at the train step's shapes."""
    from mask_rcnn_tpu_torch.ops import costs

    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        make_anchors,
    )
    from mask_rcnn_tpu_torch.ops import nms, roi_align, targets

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 1)
    n, (h, w) = 2, TRAIN_HW
    batch = train_batch(torch, n, h, w, dev)

    # K7: the head's grad (2 images x 512 sampled rois, 7x7 bins at
    # bin_stride 2) into the (2, 52, 84, 1024) bf16 C4 features.
    rois = torch.from_numpy(np.stack(
        [proposal_like_boxes(rng, 512, h, w) for _ in range(n)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn((n, 512, 7, 7, 1024), generator=gen, device=dev)
    g = g.bfloat16()
    args = ((h // 16, w // 16), 1 / 16, 0, 2)
    got = roi_align.roi_align_grouped_backward(g, rois, *args)
    want = roi_align.roi_align_grouped_backward_plain(g.float(), rois, *args)
    torch.cuda.synchronize()
    # tolerance: one bf16 rounding of the float32 sum (2^-8 relative), and
    # the float32 atomics' summation order (1e-5 of the largest value)
    rtol, atol = 2.0 ** -8, 1e-5 * want.abs().max().item()
    err = (got.float() - want).abs()
    bad = (err > atol + rtol * want.abs()).sum().item()
    ms = cuda_ms(torch, lambda: roi_align.roi_align_grouped_backward(
        g, rois, *args))
    plain_ms = cuda_ms(torch, lambda: roi_align.roi_align_grouped_backward_plain(
        g.float(), rois, *args), warmup=1, iters=3)
    scatters, merged, roi_cells = align_bwd_atomics(rois.cpu().numpy(),
                                                    args[0])
    print(f"K7 roi_align backward {tuple(g.shape)} -> {tuple(got.shape)}: "
          f"max|err| {err.max().item():.3e} (rtol {rtol:g}, atol "
          f"{atol:.3e}, {bad} outside), contiguous NHWC "
          f"{got.is_contiguous()}, kernel {ms:.4f} ms, plain f32 "
          f"{plain_ms:.4f} ms; a channel's taps {scatters}, merged cells "
          f"{merged} ({merged * 1024 * 4 / 1e6:.1f} MB of float32 atomics; "
          f"merged over whole rois {roi_cells})")
    if bad or not got.is_contiguous():
        raise AssertionError(f"K7 disagrees with its plain version at {bad} "
                             "values")
    results["roi_align_grouped_backward"] = {
        "name": "roi_align_grouped_backward", "route": "cuda",
        "source": "mask_rcnn_tpu_torch/csrc/roi_align.cu",
        "replaces": "mask_rcnn_tpu/ops/roi_align.py:282",
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
        **bound(costs.nbytes(g, rois, got),
                8 * 1024 * costs.align_samples(rois.cpu().numpy(), (h // 16,
                                                              w // 16)))}

    # K2 at the train counts: (2, 12000) score-sorted proposals -> 2000 at
    # 0.7, one block per image; a tail of invalid rows.
    n_pre, n_post = 12000, 2000
    boxes = torch.from_numpy(np.stack(
        [proposal_like_boxes(rng, n_pre, h, w) for _ in range(n)])).to(dev)
    valid = torch.from_numpy(
        (rng.rand(n, n_pre) > 0.02) & (np.arange(n_pre) < n_pre - 100)
    ).to(dev)
    fn = lambda: nms.nms_blocked(boxes, valid, 0.7, n_post)  # noqa: E731
    plain = lambda: nms.nms_blocked_plain(boxes, valid, 0.7, n_post)  # noqa
    (idx, mask), (want_idx, want_mask) = fn(), plain()
    torch.cuda.synchronize()
    n_diff = ((idx != want_idx).sum() + (mask != want_mask).sum()).item()
    ms = cuda_ms(torch, fn)
    plain_ms = cuda_ms(torch, plain, warmup=1, iters=3)
    print(f"K2 nms_blocked at train counts {tuple(boxes.shape)} -> {n_post}: "
          f"identical={n_diff == 0} (kept {mask.sum(1).tolist()}, "
          f"{scan_note(want_idx, want_mask, n_pre, n_post)}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if n_diff:
        raise AssertionError(f"K2 differs from its plain version at train "
                             f"counts at {n_diff} positions")
    k2 = results["nms_blocked"]
    k2["max_abs_err"] += float(n_diff)
    k2["train_ms"], k2["train_plain_ms"] = ms, plain_ms

    # K9a (anchor_targets) on the 65520 anchors of the 52x84 grid and K9b +
    # K8 (proposal_targets) on 2000 proposals + 8 gts per image with the
    # packed masks, under priorities drawn as the train step draws them
    # (torch.rand on the card) and under the same rounded down to 4 values
    # (equal keys straddle every quota's cut).
    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG,
                         anchor_scales=(2, 4, 8, 16, 32))
    anchors = torch.from_numpy(make_anchors(cfg, h // 16, w // 16)).to(dev)
    boxes = np.stack([proposal_like_boxes(rng, 2000, h, w) for _ in range(n)])
    # 200 proposals jittered around the gts: more positives than the quota
    gt_np = batch["bbox"].cpu().numpy()
    near = gt_np[:, rng.randint(0, 8, 200)] + rng.randn(n, 200, 4) * 8
    boxes[:, :200] = np.clip(near, 0, [h, w, h, w])
    rois = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    roi_valid = torch.from_numpy(rng.rand(n, 2000) > 0.02).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s, p = anchors.shape[0], rois.shape[1] + batch["bbox"].shape[1]
    drawn = [torch.rand(shape, generator=gen, device=dev)
             for shape in ((n, s), (n, s), (n, p), (n, p))]
    acfg, pcfg = targets.AnchorTargetConfig(), targets.ProposalTargetConfig()
    norm = ((0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    a_in = (batch["bbox"], batch["bbox_valid"], anchors, (h, w))
    p_in = (rois, roi_valid, batch["bbox"], batch["label"],
            batch["bbox_valid"], batch["mask"])
    lines = {
        "anchor_targets": dict(
            fn=lambda pri: targets.anchor_targets(*a_in, *pri[:2], acfg),
            plain=lambda pri: targets.anchor_targets_plain(*a_in, *pri[:2],
                                                           acfg),
            exact=(1,), replaces="mask_rcnn_tpu/models/targets.py:54",
            what=f"K9a anchor_targets ({n}, {s}) anchors x 8 gts"),
        "proposal_targets": dict(
            fn=lambda pri: targets.proposal_targets(
                *p_in, *pri[2:], pcfg, *norm, True),
            plain=lambda pri: targets.proposal_targets_plain(
                *p_in, *pri[2:], pcfg, *norm, True),
            exact=(0, 2, 3), replaces="mask_rcnn_tpu/models/targets.py:241",
            what=f"K9b + K8 proposal_targets ({n}, {p}) candidates, "
                 f"packed masks {tuple(batch['mask'].shape)}"),
    }
    for name, k in lines.items():
        entry = {"name": name, "route": "cuda",
                 "source": "mask_rcnn_tpu_torch/csrc/targets.cu",
                 "replaces": k["replaces"], "max_abs_err": 0.0}
        for kind, pri in (("train priorities", drawn),
                          ("tied priorities",
                           [torch.floor(q * 4) / 4 for q in drawn])):
            got, want = k["fn"](pri), k["plain"](pri)
            torch.cuda.synchronize()
            n_diff = sum((got[i] != want[i]).sum().item() for i in k["exact"])
            loc = 0 if name == "anchor_targets" else 1
            err = (got[loc] - want[loc]).abs()
            bad = (err > 1e-6 + 1e-6 * want[loc].abs()).sum().item()
            entry["max_abs_err"] = max(entry["max_abs_err"], err.max().item())
            note = f"{k['what']}, {kind}: identical={n_diff == 0}"
            if name == "anchor_targets":
                note += (f" (positives {(got[1] == 1).sum(1).tolist()}, "
                         f"negatives {(got[1] == 0).sum(1).tolist()})")
            else:
                note += (f" (positive slots {(got[2] > 0).sum(1).tolist()},"
                         f" unfilled {(got[2] < 0).sum(1).tolist()})")
            note += (f", loc max|diff| {err.max().item():.3e} (rtol 1e-6, "
                     f"atol 1e-6, {bad} outside)")
            if kind == "train priorities":
                # ms: the kernel's device time (the wrapper's host work
                # outlasts it back to back, as K10's does)
                wrapper_ms = cuda_ms(torch, lambda: k["fn"](pri))
                ms = device_ms(torch, lambda: k["fn"](pri))
                plain_ms = cuda_ms(torch, lambda: k["plain"](pri), warmup=1,
                                   iters=5)
                entry.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms)
                note += (f", kernel {ms:.4f} ms on the device (wrapper calls "
                         f"back to back {wrapper_ms:.4f} ms), plain "
                         f"{plain_ms:.4f} ms")
                n_gt = batch["bbox_valid"].sum().item()
                if name == "anchor_targets":  # an IoU per (anchor, gt) pair
                    n_bytes, read = anchor_target_bytes(a_in, got, acfg)
                    entry.update(bound(n_bytes, 12 * s * n_gt))
                else:  # IoUs, and a bilinear sample per positive mask cell
                    n_bytes, read = proposal_target_bytes(torch, p_in, got,
                                                          pcfg)
                    entry.update(bound(n_bytes, 12 * p * n_gt
                                       + 8 * read["crops"] * 14 * 14))
                note += (f"; bound over {n_bytes} bytes ("
                         + ", ".join(f"{v} {k}" for k, v in read.items())
                         + ")")
            print(note)
            if n_diff or bad:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version ({kind}): {n_diff} values, "
                                     f"{bad} locs outside the tolerance")
        results[name] = entry


def stem_params(torch, gen):
    """The stem's params on the CPU in float32: he_normal conv1 of
    ``init_extractor``, bn1 scale and bias drawn around the init's 0.5 and
    0."""
    from mask_rcnn_tpu_torch.models import resnet

    w = resnet.init_extractor(gen)["conv1"]["W"]
    return {"conv1": {"W": w},
            "bn1": {"scale": torch.rand(64, generator=gen) * 0.5 + 0.25,
                    "bias": torch.randn(64, generator=gen) * 0.1}}


def stem_inputs(torch, n, dtype, seed=SEED):
    """The stem's params (:func:`stem_params`) and a mean-subtracted
    image-like (N, 832, 1344, 3) input, on the card in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    params = stem_params(torch, gen)
    x = torch.rand((n, *TRAIN_HW, 3), generator=gen) * 255 - 120
    dev = torch.device("cuda")
    params = {k: {m: t.to(dev, dtype) for m, t in v.items()}
              for k, v in params.items()}
    return params, x.to(dev, dtype)


def check_stem_kernel(torch, results):
    """Phase 2, the stem: K10 against ``stem_forward_plain`` (the four-op
    cuDNN stem it replaces) at (1, 832, 1344, 3) and (2, 832, 1344, 3),
    bf16 and float32 (the plain side with TF32 off)."""
    from mask_rcnn_tpu_torch.models import resnet
    from mask_rcnn_tpu_torch.ops import costs

    k10 = {"name": "stem_forward", "route": "cuda",
           "source": "mask_rcnn_tpu_torch/csrc/stem.cu",
           "replaces": "mask_rcnn_tpu/models/resnet.py:103",
           "max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 2):
            params, x = stem_inputs(torch, n, dtype)
            f32 = {k: {m: t.float() for m, t in v.items()}
                   for k, v in params.items()}
            got = resnet.stem_forward(params, x)
            want = resnet.stem_forward_plain(f32, x.float())
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            top = want.abs().max().item()
            if dtype == torch.float32:
                # float32 sums of 147 taps in another order: 1e-5 of the
                # largest value
                rtol, atol = 0.0, 1e-5 * top
            else:
                # one bf16 rounding of the float32 result, plus 1e-3 of the
                # largest value
                rtol, atol = 2.0 ** -8, 1e-3 * top
            bad = (err > atol + rtol * want.abs()).sum().item()
            # the wrapper's host work (checks, weight packing, casts) takes
            # longer than the bf16 kernel: events around back-to-back calls
            # read the host's pace, the profiler the device's work
            wrapper_ms = cuda_ms(torch, lambda: resnet.stem_forward(params,
                                                                    x))
            ms = device_ms(torch, lambda: resnet.stem_forward(params, x))
            plain_ms = cuda_ms(torch, lambda: resnet.stem_forward_plain(
                params, x))
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"K10 stem {tuple(x.shape)} {name} -> {tuple(got.shape)}: "
                  f"max|err| {err.max().item():.3e} vs the float32 four-op "
                  f"stem (rtol {rtol:g}, atol {atol:.3e}, {bad} outside), "
                  f"kernel {ms:.4f} ms on the device (wrapper calls back to "
                  f"back {wrapper_ms:.4f} ms), four-op stem in {name} "
                  f"{plain_ms:.4f} ms")
            if bad:
                raise AssertionError(f"K10 disagrees with the plain stem at "
                                     f"{bad} values ({name}, batch {n})")
            k10["max_abs_err"] = max(k10["max_abs_err"], err.max().item())
            if dtype == torch.bfloat16 and n == 1:  # the serving shape
                ch, cw = -(-TRAIN_HW[0] // 2), -(-TRAIN_HW[1] // 2)
                k10.update(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                           **bound(costs.nbytes(x, params["conv1"]["W"], got),
                                   2 * n * ch * cw * 64 * 147, "bf16"))
            elif dtype == torch.bfloat16:
                k10["b2_ms"], k10["b2_plain_ms"] = ms, plain_ms
            elif n == 1:
                k10["f32_ms"], k10["f32_plain_ms"] = ms, plain_ms
    results["stem_forward"] = k10


FLAT_SPLIT = (1300, 700)  # ragged rois per image on the flat head path


def ragged_rois(torch, rng, counts):
    """Proposal-like flat rois of the 832x1344 bucket, ``counts[i]`` of
    image i, shuffled together, and their int32 image indices."""
    boxes = np.concatenate([proposal_like_boxes(rng, k, *TRAIN_HW)
                            for k in counts])
    idx = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    perm = rng.permutation(len(idx))
    dev = torch.device("cuda")
    return (torch.from_numpy(boxes[perm]).to(dev),
            torch.from_numpy(idx[perm]).to(dev))


def check_flat_kernels(torch, results):
    """Phase 2, the flat RoIAlign: K4 against ``roi_align_plain`` on
    (1, 52, 84, 1024) bf16 with 1000 rois and on (2, 52, 84, 1024) with a
    ragged 1300/700 split, 7x7 bins at bin_stride 2; K13 against the plain
    backward from (1024, 7, 7, 1024) to (2, 52, 84, 1024)."""
    from mask_rcnn_tpu_torch.ops import costs
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 5)
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16
    args = (7, 1 / 16, 0, 2)
    k4 = {"name": "roi_align", "route": "cuda",
          "source": "mask_rcnn_tpu_torch/csrc/roi_align.cu",
          "replaces": "mask_rcnn_tpu/ops/roi_align.py:149",
          "max_abs_err": 0.0}
    for counts in ((1000,), FLAT_SPLIT):
        n = len(counts)
        feats = torch.from_numpy(rng.randn(n, fh, fw, 1024).astype(
            np.float32)).to(dev).bfloat16()
        rois, idx = ragged_rois(torch, rng, counts)
        got = ra.roi_align(feats, rois, idx, *args)
        want = ra.roi_align_plain(feats.float(), rois, idx, *args)
        torch.cuda.synchronize()
        # one bf16 rounding of the float32 plain result (K1's tolerance)
        err = (got.float() - want).abs()
        bad = (err > 1e-5 + 2.0 ** -8 * want.abs()).sum().item()
        ms = cuda_ms(torch, lambda: ra.roi_align(feats, rois, idx, *args))
        plain_ms = cuda_ms(torch, lambda: ra.roi_align_plain(
            feats.float(), rois, idx, *args), warmup=1, iters=3)
        print(f"K4 roi_align (flat) {tuple(feats.shape)}, rois {counts}: "
              f"max|err| {err.max().item():.3e} (rtol 2^-8, atol 1e-5, "
              f"{bad} outside), kernel {ms:.4f} ms, plain f32 "
              f"{plain_ms:.4f} ms")
        if bad:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{bad} values ({counts})")
        k4["max_abs_err"] = max(k4["max_abs_err"], err.max().item())
        if counts == FLAT_SPLIT:  # the flat head path's shape
            k4.update(ms=ms, plain_ms=plain_ms, **bound(
                costs.nbytes(feats, rois, idx, got),
                8 * 1024 * costs.align_samples(rois.cpu().numpy(), (fh, fw))))
    results["roi_align"] = k4

    rois, idx = ragged_rois(torch, rng, (512, 512))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn((1024, 7, 7, 1024), generator=gen,
                    device=dev).bfloat16()
    shape = (2, fh, fw)
    got = ra.roi_align_backward(g, rois, idx, shape, *args[1:])
    want = ra.roi_align_backward_plain(g.float(), rois, idx, shape,
                                       *args[1:])
    torch.cuda.synchronize()
    # K7's tolerance: one bf16 rounding plus 1e-5 of the largest value
    atol = 1e-5 * want.abs().max().item()
    err = (got.float() - want).abs()
    bad = (err > atol + 2.0 ** -8 * want.abs()).sum().item()
    ms = cuda_ms(torch, lambda: ra.roi_align_backward(g, rois, idx, shape,
                                                      *args[1:]))
    plain_ms = cuda_ms(torch, lambda: ra.roi_align_backward_plain(
        g.float(), rois, idx, shape, *args[1:]), warmup=1, iters=3)
    print(f"K13 roi_align backward (flat) {tuple(g.shape)} -> "
          f"{tuple(got.shape)}: max|err| {err.max().item():.3e} (rtol 2^-8, "
          f"atol {atol:.3e}, {bad} outside), contiguous NHWC "
          f"{got.is_contiguous()}, kernel {ms:.4f} ms, plain f32 "
          f"{plain_ms:.4f} ms")
    if bad or not got.is_contiguous():
        raise AssertionError(f"K13 disagrees with its plain version at {bad} "
                             "values")
    results["roi_align_backward"] = {
        "name": "roi_align_backward", "route": "cuda",
        "source": "mask_rcnn_tpu_torch/csrc/roi_align.cu",
        "replaces": "mask_rcnn_tpu/ops/roi_align.py:189",
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
        **bound(costs.nbytes(g, rois, idx, got),
                8 * 1024 * costs.align_samples(rois.cpu().numpy(), (fh, fw)))}


SERVE_ROIS = (1000, 100)  # the serving head passes' rois at batch 1


def pool_row_reads(rois, p, scale=1 / 16, hw=(52, 84)):
    """Feature positions that the redesigned K12 reads for these flat rois:
    each (roi, bin row) reads the union of its bins' columns over the row's
    rows once."""
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    r = rois.float()
    ys, ye = ra._pool_bounds(r[:, 0], r[:, 2], hw[0], p, scale)
    xs, xe = ra._pool_bounds(r[:, 1], r[:, 3], hw[1], p, scale)
    cols = (xe[:, -1] - xs[:, 0]).clamp(min=0)
    return float(((ye - ys).clamp(min=0) * cols[:, None]).sum())


def crop_bwd_atomics(rois, idx, p, n, c, stride2=False, scale=1 / 16,
                     hw=(52, 84)):
    """Float4 atomics that K11 issues for these flat rois: per (roi, py) row
    of cells with a gradient, one per (feature row of nonzero weight,
    column that a live cell's taps reach with nonzero weight, 4 channels).
    ``stride2``: the gradient is zero on every odd py or odd px."""
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    r = rois.float()
    zero = idx.long() * 0
    ay = ra._crop_resize_matrix(r[:, 0], r[:, 2], hw[0], hw[0], zero, p,
                                scale)
    ax = ra._crop_resize_matrix(r[:, 1], r[:, 3], hw[1], hw[1], zero, p,
                                scale)
    live = ((idx >= 0) & (idx < n)).float()
    if stride2:
        ay, ax = ay[:, ::2], ax[:, ::2]
    rows = (ay != 0).sum(-1).float()  # (R, py)
    cols = (ax != 0).any(1).sum(-1).float()  # (R,)
    return float((rows * (cols * live)[:, None]).sum()) * c / 4


def crop_row_reads(rois, p, scale=1 / 16, hw=(52, 84)):
    """Feature positions that K5 reads for these flat rois, (redesigned,
    earlier): each (roi, cell row) reads its one or two feature rows (two
    unless the y tap sits on the border) at each distinct column that its
    cells' x taps reach, once; the earlier form read four taps a cell."""
    r = rois.float().cpu().numpy()

    def taps(lo, hi, size):  # crop_tap's (low, high), (R, P)
        lo_i = np.round(lo * scale)
        hi_i = np.maximum(np.round(hi * scale), lo_i + 1.0)
        step = (hi_i - lo_i - 1.0) / max(p - 1, 1)
        i = np.arange(p, dtype=np.float32)
        c = np.clip(lo_i[:, None] + i * step[:, None], 0.0, size - 1.0)
        low = np.minimum(np.floor(c).astype(np.int64), size - 1)
        return low, np.minimum(low + 1, size - 1)

    yl, yh = taps(r[:, 0], r[:, 2], hw[0])
    xl, xh = taps(r[:, 1], r[:, 3], hw[1])
    rows = (1 + (yh != yl)).sum(1)  # (R,)
    cols = np.sort(np.concatenate([xl, xh], 1), 1)
    distinct = 1 + (np.diff(cols, axis=1) != 0).sum(1)  # (R,)
    return float((rows * distinct).sum()), float(4 * p * p * len(r))


TRAIN_ROIS = 512  # sampled rois per image at batch 2
POOL_ZERO_BLOCK = (slice(10, 20), slice(20, 40))  # of phase 2's features


def pool_features(rng, n):
    """Phase 2's pooler features, (n, 52, 84, 1024) float32: relu'd values,
    half of them exact zeros as on relu'd res4, and a block of zeros in the
    first image."""
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16
    f = np.maximum(rng.randn(n, fh, fw, 1024), 0).astype(np.float32)
    f[(0, *POOL_ZERO_BLOCK)] = 0.0
    return f


def pool_rois(rng, n, r):
    """Phase 2's flat rois, r proposal-like boxes an image, the last r // 20
    of the first image's zero (padded slots, as proposals have), and their
    image indices (int32)."""
    boxes = np.concatenate([proposal_like_boxes(rng, r, *TRAIN_HW)
                            for _ in range(n)])
    boxes[r - r // 20:r] = 0.0
    return boxes, np.repeat(np.arange(n, dtype=np.int32), r)


def check_pool_kernels(torch, results):
    """Phase 2, the alternate poolers: K5 and K6 at the serving shapes
    ((1, 52, 84, 1024) bf16 C4 features, 1000 and 100 rois), K5 beside
    the write floor and its own stores alone, K6 also on
    features that hold NaN, +inf and -inf (a bin with a NaN or +inf pools to
    0), K11 and K12 at the train shape ((2, 52, 84, 1024), 512 rois per
    image; K11 on a dense gradient and on the one res5's stride-2 convs
    send, zero on every odd py or odd px), each against its plain version;
    then K12 on rois inside a block of exact zeros, where every position of
    a bin ties."""
    from mask_rcnn_tpu_torch.ops import costs
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    def pool_reads(rois):  # on the (52, 84) features, 14x14 bins
        return costs.pool_reads(rois, 14, 1 / 16, (52, 84))

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 2)
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16

    def features(n):
        return torch.from_numpy(pool_features(rng, n)).to(dev).bfloat16()

    def flat_rois(n, r):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in pool_rois(rng, n, r))

    def entry(name, line):
        return {"name": name, "route": "cuda",
                "source": "mask_rcnn_tpu_torch/csrc/roi_pool.cu",
                "replaces": f"mask_rcnn_tpu/ops/roi_align.py:{line}",
                "max_abs_err": 0.0}

    def compare(label, got, want, atol):
        """Within one bf16 rounding (2^-8 relative) of the float32 plain
        result, plus ``atol``."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bad = (err > atol + 2.0 ** -8 * want.float().abs()).sum().item()
        print(f"{label}: max|err| {err.max().item():.3e} (rtol 2^-8, atol "
              f"{atol:.3e}, {bad} outside)")
        if bad:
            raise AssertionError(f"{label} disagrees with its plain version "
                                 f"at {bad} values")
        return err.max().item()

    k5, k6 = entry("crop_and_resize", 304), entry("roi_pool", 381)
    feats = features(1)
    for r in SERVE_ROIS:
        args = (*flat_rois(1, r), 14, 1 / 16)
        got = ra.crop_and_resize(feats, *args)
        err = compare(f"K5 crop_and_resize {r} rois", got,
                      ra.crop_and_resize_plain(feats.float(), *args), 1e-5)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        ms = cuda_ms(torch, lambda: ra.crop_and_resize(feats, *args))
        plain_ms = cuda_ms(torch, lambda: ra.crop_and_resize_plain(
            feats.float(), *args), warmup=1, iters=2)
        print(f"K5 crop_and_resize {r} rois: kernel {ms:.4f} ms, plain f32 "
              f"{plain_ms:.4f} ms")
        # The write floor: torch's fill of a tensor of K5's output, a
        # yardstick only (the port never calls it for K5); and K5 on its
        # stores alone: every roi index out of range, so each block writes
        # zeros through the kernel's own 16-byte stores and reads nothing.
        # Device times from the profiler beside the events: at 100 rois
        # the wrapper's host time outlasts the kernel.
        out = torch.empty_like(got)
        no_idx = torch.full_like(args[1], -1)
        zeros = ra.crop_and_resize(feats, args[0], no_idx, *args[2:])
        torch.cuda.synchronize()
        if zeros.any():
            raise AssertionError("K5 wrote a nonzero value for a roi of an "
                                 "out-of-range index")
        wrote = costs.nbytes(got)

        def one_launch_ms(fn):
            """Device ms a call of ``fn``, which runs one kernel, from the
            profiler; None where each of three sessions recorded another
            count (late in a process a session now and then drops
            activities)."""
            for _ in range(3):
                dev_ms, activities = device_profile(torch, fn)
                if activities == 1:
                    return dev_ms
            return None

        times = {label: (cuda_ms(torch, fn), one_launch_ms(fn))
                 for label, fn in (
            ("out.zero_() (the write floor)", out.zero_),
            ("K5 on its stores alone (every index out of range)",
             lambda: ra.crop_and_resize(feats, args[0], no_idx, *args[2:])),
            ("K5", lambda: ra.crop_and_resize(feats, *args)))}
        (_, floor), (_, k5_dev) = times["out.zero_() (the write floor)"], \
            times["K5"]
        print(f"K5 against the write floor, {r} rois, the {tuple(got.shape)} "
              f"{str(got.dtype)[6:]} output, ms by CUDA events / device "
              f"(profiler; TB/s at the device time): " + "; ".join(
                  f"{label} {t:.4f} / {d:.4f} ({wrote / d / 1e9:.3f} TB/s)"
                  if d else f"{label} {t:.4f} / not measured (the profiler "
                  "dropped launches)"
                  for label, (t, d) in times.items())
              + (f"; K5 = {k5_dev / floor:.2f}x the floor"
                 if floor and k5_dev else ""))
        reads, old_reads = crop_row_reads(args[0], 14)
        print(f"K5 logical bytes, {r} rois: {reads * 2048 / 1e6:.1f} MB of "
              f"tap reads (two rows of each distinct column of a cell row; "
              f"the earlier form read four taps a cell: "
              f"{old_reads * 2048 / 1e6:.1f} MB), {wrote / 1e6:.1f} MB "
              f"written")

        got, want = ra.roi_pool(feats, *args), ra.roi_pool_plain(feats, *args)
        torch.cuda.synchronize()
        n_diff = (got != want).sum().item()
        k6["max_abs_err"] = max(k6["max_abs_err"], float(n_diff))
        k6_ms = cuda_ms(torch, lambda: ra.roi_pool(feats, *args))
        k6_plain_ms = cuda_ms(torch, lambda: ra.roi_pool_plain(feats, *args),
                              warmup=1, iters=2)
        print(f"K6 roi_pool {r} rois: identical={n_diff == 0} (zeros "
              f"{(want == 0).float().mean().item():.3f}), kernel "
              f"{k6_ms:.4f} ms, plain {k6_plain_ms:.4f} ms")
        if n_diff:
            raise AssertionError(f"K6 differs from its plain version at "
                                 f"{n_diff} values ({r} rois)")
        # logical bytes, whether from L1, L2 or memory: each (roi, bin row)
        # reads its rows x the columns of its bins once
        print(f"K6 logical bytes, {r} rois: "
              f"{pool_row_reads(args[0], 14) * 2048 / 1e6:.1f} MB of feature "
              f"reads (the earlier form read every bin whole: "
              f"{pool_reads(args[0]) * 2048 / 1e6:.1f} MB), "
              f"{costs.nbytes(got) / 1e6:.1f} MB written")
        if r == SERVE_ROIS[0]:  # the box pass's; the mask pass's is printed
            k5["ms"], k5["plain_ms"] = ms, plain_ms
            k6["ms"], k6["plain_ms"] = k6_ms, k6_plain_ms
            io = costs.nbytes(feats, args[0], args[1], got)
            # four bilinear taps per output value; a compare per value read
            k5.update(bound(io, 8 * got.numel()))
            k6.update(bound(io, 1024 * pool_reads(args[0])))
            k6_args = args

    # NaN, +inf and -inf among the features. A bin that holds a NaN or
    # +inf pools to 0, as the JAX function's isfinite rule gives.
    odd = feats.clone()
    spots = np.random.RandomState(SEED + 3).choice(odd.numel(), 3 * 20000,
                                                  replace=False)
    spots = torch.from_numpy(spots).to(dev)
    for k, v in enumerate((float("nan"), float("inf"), float("-inf"))):
        odd.view(-1)[spots[k * 20000:(k + 1) * 20000]] = v
    got, want = ra.roi_pool(odd, *k6_args), ra.roi_pool_plain(odd, *k6_args)
    torch.cuda.synchronize()
    n_diff = (got != want).sum().item()
    zeroed = ((want == 0) & (ra.roi_pool_plain(feats, *k6_args) != 0))
    print(f"K6 roi_pool on features with NaN and +-inf: identical="
          f"{n_diff == 0}, {zeroed.sum().item()} values zeroed by a NaN or "
          f"+inf in their bin, all finite={bool(torch.isfinite(got).all())}")
    if n_diff or not zeroed.any():
        raise AssertionError(f"K6 differs from its plain version on "
                             f"non-finite features at {n_diff} values")
    k6["max_abs_err"] = max(k6["max_abs_err"], float(n_diff))
    results["crop_and_resize"], results["roi_pool"] = k5, k6

    # The backwards at the train shape: 2 images x 512 rois, 14x14 bins.
    n = 2
    feats = features(n)
    rois, idx = flat_rois(n, TRAIN_ROIS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn((n * TRAIN_ROIS, 14, 14, 1024), generator=gen,
                    device=dev).bfloat16()
    g_s2 = g.clone()  # res5's stride-2 1x1 convs read the even cells only
    g_s2[:, 1::2] = 0.0
    g_s2[:, :, 1::2] = 0.0
    shape = (n, fh, fw)
    for name, line, grad, fn, plain, io, flops in (
        ("crop_and_resize_backward", 359, g,
         lambda: ra.crop_and_resize_backward(g, rois, idx, shape, 1 / 16),
         lambda: ra.crop_and_resize_backward_plain(g.float(), rois, idx,
                                                   shape, 1 / 16),
         (g, rois, idx), 8 * g.numel()),
        ("crop_and_resize_backward", 359, g_s2,
         lambda: ra.crop_and_resize_backward(g_s2, rois, idx, shape, 1 / 16),
         lambda: ra.crop_and_resize_backward_plain(g_s2.float(), rois, idx,
                                                   shape, 1 / 16),
         None, None),
        ("roi_pool_backward", 441, g,
         lambda: ra.roi_pool_backward(g, feats, rois, idx, 1 / 16),
         lambda: ra.roi_pool_backward_plain(g.float(), feats.float(), rois,
                                            idx, 1 / 16),
         (g, feats, rois, idx), 2 * 1024 * pool_reads(rois)),
    ):
        got, want = fn(), plain()
        s2 = grad is g_s2
        label = f"{'K11' if 'crop' in name else 'K12'} {name} " \
                f"{tuple(g.shape)}{' stride-2 gradient' if s2 else ''} " \
                f"-> {tuple(got.shape)}"
        # the float32 atomics' order: 1e-5 of the largest value
        err = compare(label, got, want, 1e-5 * want.abs().max().item())
        if not got.is_contiguous():
            raise AssertionError(f"{name}: the grad is not contiguous NHWC")
        ms = cuda_ms(torch, fn)
        plain_ms = cuda_ms(torch, plain, warmup=1, iters=2)
        print(f"{label}: kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms")
        if name == "roi_pool_backward":
            # logical bytes, whether from L1, L2 or memory: each (roi, bin
            # row) reads its rows x columns once; at most one float32
            # atomic per position read (one per tied row of a column)
            reads = pool_row_reads(rois, 14) * 1024
            print(f"K12 logical bytes: {reads * 2 / 1e6:.1f} MB of feature "
                  f"reads (the earlier form read each bin twice and its "
                  f"tied columns once more: over "
                  f"{2 * 2 * 1024 * pool_reads(rois) / 1e6:.1f} MB), "
                  f"at most {reads * 4 / 1e6:.1f} MB of atomics")
        else:
            atomics = crop_bwd_atomics(rois, idx, 14, n, 1024, s2)
            print(f"K11 logical bytes{' (stride 2)' if s2 else ''}: "
                  f"{costs.nbytes(grad) / 1e6:.1f} MB of gradient reads, "
                  f"{atomics / 1e6:.2f} M float4 atomics "
                  f"({atomics * 16 / 1e6:.1f} MB; the earlier form issued "
                  f"one scalar atomic per nonzero (cell, tap, row, channel):"
                  f" up to {4 * (grad != 0).sum().item() / 1e6:.1f} M)")
        if name == "crop_and_resize_backward" and not s2:
            # the same launch on a zero gradient: every load, no atomic
            zero_g = torch.zeros_like(g)
            zero_ms = cuda_ms(torch, lambda: ra.crop_and_resize_backward(
                zero_g, rois, idx, shape, 1 / 16))
            print(f"K11 on an all-zero gradient (its loads, no atomic): "
                  f"{zero_ms:.4f} ms")
        if s2:
            results[name].update(max_abs_err=max(
                results[name]["max_abs_err"], err), s2_ms=ms,
                s2_plain_ms=plain_ms)
            continue
        results[name] = entry(name, line)
        results[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(costs.nbytes(*io, got), flops))

    # K12's tie rule: rois inside the zero block, where every position of a
    # bin ties; an integer gradient makes every weighted sum exact.
    y0, x0 = POOL_ZERO_BLOCK[0].start * 16, POOL_ZERO_BLOCK[1].start * 16
    tie = np.stack([rng.uniform(y0, y0 + 64, 64),
                    rng.uniform(x0, x0 + 160, 64),
                    rng.uniform(y0 + 80, y0 + 150, 64),
                    rng.uniform(x0 + 180, x0 + 300, 64)], 1)
    tie_rois = torch.from_numpy(tie.astype(np.float32)).to(dev)
    tie_idx = torch.zeros(64, dtype=torch.int32, device=dev)
    tie_g = torch.from_numpy(
        rng.randint(-4, 5, (64, 14, 14, 1024)).astype(np.float32)
    ).to(dev).bfloat16()
    got = ra.roi_pool_backward(tie_g, feats, tie_rois, tie_idx, 1 / 16)
    want = ra.roi_pool_backward_plain(tie_g, feats, tie_rois, tie_idx, 1 / 16)
    torch.cuda.synchronize()
    n_diff = (got != want).sum().item()
    split = (want.float() != want.float().round()).sum().item()
    print(f"K12 tie case (64 rois in a block of zeros): identical="
          f"{n_diff == 0}, {split} fractional gradients from an integer one "
          "(ties split)")
    if n_diff or not split:
        raise AssertionError(f"K12 tie case differs from its plain autograd "
                             f"at {n_diff} values")


def check_train_reference(torch, pooling="align"):
    """Phase 3, training side: the train loss and every gradient on the GPU
    (kernels) against the plain path on the CPU, float32, small input, the
    same sampling priorities."""
    from mask_rcnn_tpu_torch.models import mask_rcnn, rpn
    from mask_rcnn_tpu_torch.models.mask_rcnn import map_params
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
    )
    from mask_rcnn_tpu_torch.models.train_model import train_loss
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    cfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=3, min_size=64, max_size=96, anchor_scales=(1.0, 2.0, 4.0),
        pooling=pooling,
        proposal=rpn.ProposalConfig(n_train_pre_nms=600,
                                    n_train_post_nms=120),
    )
    n, h, w, g = 2, 256, 320, 4
    kw = dict(anchor_cfg=AnchorTargetConfig(n_sample=64),
              proposal_cfg=ProposalTargetConfig(n_sample=32))
    gen = torch.Generator().manual_seed(SEED)
    params = mask_rcnn.init_params(cfg, gen)
    n_anchor = (h // 16) * (w // 16) * cfg.n_anchor
    pri = {"proposal": tuple(torch.rand((n, 120 + g), generator=gen)
                             for _ in range(2)),
           "anchor": tuple(torch.rand((n, n_anchor), generator=gen)
                           for _ in range(2))}
    out = []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        p = map_params(lambda t: t.detach().to(dev).requires_grad_(True),
                       params)
        batch = train_batch(torch, n, h, w, dev, max_boxes=g, n_fg_class=3)
        pr = {k: tuple(t.to(dev) for t in v) for k, v in pri.items()}
        loss, metrics = train_loss(p, cfg, batch, pr, **kw)
        flat = flatten_params(p)
        names = sorted(flat)
        grads = torch.autograd.grad(loss, [flat[k] for k in names],
                                    allow_unused=True)
        out.append(({k: v.item() for k, v in metrics.items()},
                    {k: gr.cpu() for k, gr in zip(names, grads)
                     if gr is not None}))
    (want_m, want_g), (got_m, got_g) = out
    for k, v in want_m.items():
        rel = abs(got_m[k] - v) / max(abs(v), 1e-12)
        print(f"small f32 train reference, pooling={pooling} (GPU vs CPU "
              f"plain): {k} {got_m[k]:.7g} vs {v:.7g}, rel err {rel:.2e} "
              "(rtol 1e-4)")
        assert rel <= 1e-4, f"{k} differs from the CPU reference"
    assert want_m["roi_mask_loss"] > 0, "no positive roi in the reference"
    assert set(got_g) == set(want_g), "the GPU path grads other leaves"
    worst = max(((got_g[k] - v).abs().max() / v.abs().max()).item()
                for k, v in want_g.items())
    # cuDNN's float32 algorithms sum in another order: 2e-3 of each leaf's
    # largest gradient (readings on an H100: 2.3e-4)
    print(f"small f32 train reference, pooling={pooling}: grads of "
          f"{len(want_g)} leaves, worst max|err| / max|grad| {worst:.3e} "
          "(tolerance 2e-3)")
    assert worst <= 2e-3, "gradients differ from the CPU reference"


def drive_train_path(torch, kernels, pooling="align", reps=10):
    """Phase 5: the port's training path at full width with the RoI pooler
    ``pooling``, 3 warm-up and ``reps`` timed steps; returns the launch
    counts of the run and the step's timings."""
    from mask_rcnn_tpu_torch import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        init_params,
    )
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
                         anchor_scales=(2, 4, 8, 16, 32), pooling=pooling,
                         compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    opt, _ = make_optimizer(params, 0.02, 1000)
    state = create_train_state(params, opt)
    n, (h, w) = 2, TRAIN_HW
    batch = train_batch(torch, n, h, w, dev)
    step = make_train_step(cfg, opt)
    flat = flatten_params(params)
    before = {k: v.detach().clone() for k, v in flat.items()}
    print(f"train state (pooling={pooling}) built in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{len(opt.trainable)} trainable and "
          f"{len(flat) - len(opt.trainable)} frozen leaves, "
          f"{sum(v.numel() for v in flat.values())} params")

    for wrapper in kernels:
        wrapper.launches = 0
    history = []
    for _ in range(3):
        state, metrics = step(state, batch, SEED)
        history.append(metrics)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        state, metrics = step(state, batch, SEED)
        history.append(metrics)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    ms = start.elapsed_time(end) / reps
    counts = {w.__name__: w.launches for w in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    assert state.step == 3 + reps, state.step
    losses = torch.stack([torch.stack(list(m.values())) for m in history])
    assert torch.isfinite(losses).all(), "a train loss is not finite"
    print("train losses (step: rpn_loc rpn_cls roi_loc roi_cls roi_mask "
          "total):")
    for i, row in enumerate(losses.tolist()):
        print(f"  {i + 1:2d}: " + " ".join(f"{v:.5f}" for v in row))
    frozen = [k for k in flat if k not in opt.trainable]
    changed = [k for k in frozen if not torch.equal(flat[k], before[k])]
    still = [k for k in opt.trainable if torch.equal(flat[k], before[k])]
    assert not changed, f"frozen params changed: {changed[:5]}"
    assert not still, f"trainable params did not move: {still[:5]}"
    print(f"{len(frozen)} frozen leaves bit-unchanged, all "
          f"{len(opt.trainable)} trainable leaves moved after {3 + reps} "
          "steps")
    require_launched(counts, f"train path (pooling={pooling})")
    print(f"train step, pooling={pooling}, b{n} {h}x{w} bf16 (float32 "
          f"masters), R-50-C4 COCO: "
          f"{ms:.3f} ms/step (CUDA events over {reps} steps after 3 warm-up), "
          f"{n * 1e3 / ms:.3f} img/s; host clock {host_ms:.3f} ms/step; "
          f"peak allocated {peak_gb:.2f} GiB")
    extra = {}
    if pooling == "align":
        extra["stem_ab"] = time_stem_ab(torch, step, state, batch, reps)
        extra["k2_on_step"] = time_k2_on_step(torch, step, state, batch)
    extra["device_ms_per_step"] = profile_train(torch, step, state, batch)
    return counts, ms, host_ms, peak_gb, extra


def time_k2_on_step(torch, step, state, batch):
    """K2 on the train step's own proposals: one more step runs with the
    RPN's ``nms_padded`` recording the score-sorted boxes and valid flags
    that it hands to ``nms_blocked``; then K2 against its plain version on
    them (identical positions and masks), both timed, and where the scan
    stopped. The counts of the step's run were read before this."""
    from mask_rcnn_tpu_torch.models import rpn
    from mask_rcnn_tpu_torch.ops import costs, nms

    padded, seen = rpn.nms_padded, []

    def record(bbox, score, thresh, max_out, valid=None, presorted=False):
        assert presorted and valid is not None
        seen.append((bbox.detach().float().contiguous().clone(),
                     valid.contiguous().clone(), thresh, max_out))
        return padded(bbox, score, thresh, max_out, valid=valid,
                      presorted=presorted)

    rpn.nms_padded = record
    try:
        step(state, batch, SEED)
    finally:
        rpn.nms_padded = padded
    ((boxes, valid, thresh, max_out),) = seen
    n = boxes.shape[1]
    assert n > nms.SMALL_MAX_N, "the step's proposals did not reach K2"
    fn = lambda: nms.nms_blocked(boxes, valid, thresh, max_out)  # noqa: E731
    plain = lambda: nms.nms_blocked_plain(boxes, valid, thresh,  # noqa: E731
                                          max_out)
    (idx, mask), (want_idx, want_mask) = fn(), plain()
    torch.cuda.synchronize()
    n_diff = ((idx != want_idx).sum() + (mask != want_mask).sum()).item()
    ms = cuda_ms(torch, fn)
    plain_ms = cuda_ms(torch, plain, warmup=1, iters=3)
    stops = costs.nms_stops(want_idx, want_mask, n, max_out)
    print(f"K2 nms_blocked on the align train step's proposals "
          f"{tuple(boxes.shape)} -> {max_out} at {thresh}: identical="
          f"{n_diff == 0} (valid {valid.sum(1).tolist()}, kept "
          f"{mask.sum(1).tolist()}, {scan_note(want_idx, want_mask, n, max_out)}"
          f"), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if n_diff:
        raise AssertionError(f"K2 differs from its plain version on the "
                             f"train step's proposals at {n_diff} positions")
    return {"ms": ms, "plain_ms": plain_ms, "scan_stop": stops,
            "kept": mask.sum(1).tolist(), "valid": valid.sum(1).tolist()}


def time_stem_ab(torch, step, state, batch, reps):
    """The align train step with K10 and with the four-op stem it replaced
    (``stem_forward_plain`` swapped in for ``resnet.stem_forward``), in the
    order K10, four-op, four-op, K10, each after one warm-up step: CUDA
    events and the host clock over ``reps`` steps. Shows how much of the
    step's time the stem's choice moves."""
    from mask_rcnn_tpu_torch.models import resnet

    kernel = resnet.stem_forward
    out = {"k10": [], "four_op": []}
    try:
        for name in ("k10", "four_op", "four_op", "k10"):
            resnet.stem_forward = kernel if name == "k10" \
                else resnet.stem_forward_plain
            state, _ = step(state, batch, SEED)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                state, _ = step(state, batch, SEED)
            end.record()
            end.synchronize()
            out[name].append({
                "ms": start.elapsed_time(end) / reps,
                "host_ms": (time.perf_counter() - t0) * 1e3 / reps})
    finally:
        resnet.stem_forward = kernel
    for name, runs in out.items():
        print(f"align train step with the {name} stem (K10, four-op, "
              f"four-op, K10 order): " + ", ".join(
                  f"{r['ms']:.3f} ms (host {r['host_ms']:.3f})" for r in runs)
              + f" over {reps} steps each")
    return out


def drive_flat_head(torch, kernels):
    """The flat head path: ``head_forward`` on flat rois with image indices
    at full width (R-50 res5, 80 classes, bf16) on relu'd features of a
    2-image 832x1344 batch, rois split 1300/700, forward and backward under
    ``align``; returns the launch counts of that run. Then, with equal
    counts, the flat head against the grouped one."""
    from mask_rcnn_tpu_torch.models import heads
    from mask_rcnn_tpu_torch.models.mask_rcnn import cast_params, map_params

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 6)
    params = cast_params(map_params(
        lambda t: t.to(dev), heads.init_head(
            torch.Generator().manual_seed(SEED), N_CLASS_FG + 1)),
        "bfloat16")
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16
    feats = torch.from_numpy(np.maximum(rng.randn(2, fh, fw, 1024), 0)
                             .astype(np.float32)).to(dev).bfloat16()
    rois, idx = ragged_rois(torch, rng, FLAT_SPLIT)

    def run():
        f = feats.detach().requires_grad_(True)
        out = heads.head_forward(params, f, rois, roi_indices=idx)
        loss = (out["cls_locs"].float().square().mean()
                + torch.logsumexp(out["scores"].float(), -1).mean()
                + torch.sigmoid(out["masks"].float()).mean())
        loss.backward()
        return out, f.grad

    for wrapper in kernels:
        wrapper.launches = 0
    out, grad = run()
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in kernels}
    for k, v in out.items():
        assert torch.isfinite(v).all(), f"flat head: {k} not finite"
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    require_launched(counts, "flat head path (align, rois 1300/700)")
    ms = cuda_ms(torch, run, warmup=1, iters=5)
    print(f"flat head forward+backward, {sum(FLAT_SPLIT)} rois "
          f"{FLAT_SPLIT}, R-50 res5, bf16: {ms:.3f} ms (CUDA events); "
          f"outputs {[(k, tuple(v.shape)) for k, v in out.items()]}")

    # Equal counts: the flat head against the grouped head. K4 and K1 run
    # the same device code on the same rois, so the pooled features must be
    # bit-identical, and so must the head's outputs (the same torch ops on
    # the same values; 1e-2 of the largest value should cuDNN pick another
    # algorithm, bf16). K13 and K7 on the same pooled gradient differ by
    # their atomics' order only, and each rounds its float32 sum to bf16
    # once: one bf16 ulp (2^-7 relative) plus 1e-5 of the largest value.
    # The features' gradients through the whole head add cuDNN's
    # bf16 backward, whose summation order may change between calls: 1e-2
    # of the largest value.
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    grouped = torch.stack([ragged_rois(torch, rng, (1000,))[0]
                           for _ in range(2)])
    flat_rois = grouped.reshape(-1, 4)
    flat_idx = torch.arange(2000, device=dev, dtype=torch.int32) // 1000
    with torch.no_grad():
        same = torch.equal(
            ra.roi_align_grouped(feats, grouped, 7, 1 / 16, 0, 2).reshape(
                2000, 7, 7, 1024),
            ra.roi_align(feats, flat_rois, flat_idx, 7, 1 / 16, 0, 2))
        gp = torch.randn((2000, 7, 7, 1024), device=dev).bfloat16()
        g7 = ra.roi_align_grouped_backward(gp.reshape(2, 1000, 7, 7, 1024),
                                           grouped, (fh, fw), 1 / 16, 0, 2)
        g13 = ra.roi_align_backward(gp, flat_rois, flat_idx, (2, fh, fw),
                                    1 / 16, 0, 2)
        kerr = (g13.float() - g7.float()).abs()
        kbad = (kerr > 1e-5 * g7.float().abs().max() + 2.0 ** -7
                * g7.float().abs()).sum().item()
    f1 = feats.detach().requires_grad_(True)
    f2 = feats.detach().requires_grad_(True)
    want = heads.head_forward(params, f1, grouped)
    got = heads.head_forward(params, f2, flat_rois, roi_indices=flat_idx)
    worst = 0.0
    for k in want:
        top = want[k].float().abs().max().item()
        err = (got[k].float() - want[k].float()).abs().max().item()
        worst = max(worst, err / top)
    gy = [torch.randn(v.shape, device=dev).to(v.dtype) for v in want.values()]
    (g1,) = torch.autograd.grad(list(want.values()), f1, gy)
    (g2,) = torch.autograd.grad(list(got.values()), f2, gy)
    gworst = ((g2.float() - g1.float()).abs().max()
              / g1.float().abs().max()).item()
    print(f"flat vs grouped, 1000 rois per image: pooled features identical="
          f"{same}; K13 vs K7 on one pooled gradient max|err| "
          f"{kerr.max().item():.3e} ({kbad} outside one bf16 ulp + 1e-5 of "
          f"the largest); head outputs max|err| / max {worst:.3e}, "
          f"features' grads through the head max|err| / max {gworst:.3e} "
          "(tolerances 1e-2)")
    assert same, "K4 and K1 pool differently on the same rois"
    assert not kbad, "K13 and K7 disagree on the same gradient"
    assert worst <= 1e-2, "flat head outputs differ from the grouped head's"
    assert gworst <= 1e-2, "flat head gradients differ from grouped ones"
    return counts, ms


class CallSeconds:
    """Records the synchronised wall seconds of every call of ``cls``'s
    method ``name`` made while it is entered (the drivers build their
    evaluators, reports and models themselves)."""

    def __init__(self, torch, cls, name="__call__"):
        self.torch, self.cls, self.name, self.seconds = torch, cls, name, []

    def __enter__(self):
        orig, torch, seconds = getattr(self.cls, self.name), self.torch, \
            self.seconds
        self.orig = orig

        def timed(obj, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(obj, *args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def eval_seconds(torch):
    """:class:`CallSeconds` of every ``InstanceSegmentationEvaluator``
    call."""
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
    )

    return CallSeconds(torch, InstanceSegmentationEvaluator)


def vis_seconds(torch):
    """:class:`CallSeconds` of every ``VisReport`` call."""
    from mask_rcnn_tpu_torch.engine.evaluator import VisReport

    return CallSeconds(torch, VisReport)


LOOP_HW = (480, 640)  # the train loop's images, before resizing
LOOP_SIZES = (800, 1333)  # its min_size / max_size


def rectangles_dataset(rng, n, h, w):
    """In-memory instance-segmentation examples (img uint8 HWC, bboxes,
    labels, masks) built like tests/test_engine.py::make_dataset: noise
    with 2-4 coloured rectangles of the 80 classes; all landscape."""
    examples = []
    for _ in range(n):
        img = rng.randint(0, 100, (h, w, 3)).astype(np.uint8)
        g = rng.randint(2, 5)
        masks = np.zeros((g, h, w), np.int32)
        boxes = []
        for k in range(g):
            y1, x1 = rng.randint(0, h * 3 // 4), rng.randint(0, w * 3 // 4)
            y2 = y1 + rng.randint(h // 12, h // 4)
            x2 = x1 + rng.randint(w // 12, w // 4)
            img[y1:y2, x1:x2] = rng.randint(100, 256, 3)
            masks[k, y1:y2, x1:x2] = 1
            boxes.append((y1, x1, y2, x2))
        examples.append((img, np.asarray(boxes, np.float32),
                         rng.randint(0, N_CLASS_FG, g).astype(np.int32),
                         masks))

    class Dataset:
        class_names = tuple(f"class{i}" for i in range(N_CLASS_FG))

        def __len__(self):
            return len(examples)

        def __getitem__(self, i):
            return examples[i]

        def image_sizes(self):
            return [(h, w)] * len(examples)

    return Dataset()


def read_log(out):
    with open(os.path.join(out, "log")) as f:
        return json.load(f)


def drive_train_loop(torch, kernels):
    """The train loop at full width: ``train()`` with R-50-C4, 80
    classes, anchor scales (2, 4, 8, 16, 32), min 800 / max 1333, bf16 with
    float32 masters, batch 2, on 16 in-memory 480x640 images (resized to
    800x1067 in the 832x1344 bucket, 8 steps an epoch) and 4 val images;
    COCO evaluation, checkpoint and log every 4 steps. Run A stops at step
    4; run B resumes from A's checkpoint and runs to step 8. Returns the
    launch counts of both runs, ms per step and eval s per image."""
    import tempfile

    from mask_rcnn_tpu_torch.data import MaskRCNNTransform, TrainLoader
    from mask_rcnn_tpu_torch.engine import trainer
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
    )
    from mask_rcnn_tpu_torch.engine.loop import train
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        init_params,
    )
    from mask_rcnn_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 7)
    train_ds = rectangles_dataset(rng, 16, *LOOP_HW)
    val_ds = rectangles_dataset(rng, 4, *LOOP_HW)
    lo, hi = LOOP_SIZES
    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG, min_size=lo, max_size=hi,
                         anchor_scales=(2, 4, 8, 16, 32),
                         compute_dtype="bfloat16")

    def loader():
        return TrainLoader(train_ds, MaskRCNNTransform(
            lo, hi, cfg.mean, train=True, rng=np.random.RandomState(SEED)),
            batch_size=2, max_boxes=8, min_size=lo, max_size=hi, seed=SEED)

    evaluator = InstanceSegmentationEvaluator(
        val_ds, val_ds.class_names, kind="coco", batch_size=2)
    kw = dict(max_epoch=1.0, evaluator=evaluator, eval_interval_epochs=0.5,
              log_interval=4, checkpoint_interval_steps=4, seed=SEED,
              device=dev)
    assert loader().steps_per_epoch() == 8
    assert loader().position_for_step(4) == (0, 4)
    for wrapper in kernels:
        wrapper.launches = 0
    with eval_seconds(torch) as ev, \
            tempfile.TemporaryDirectory(prefix="mrcnn_train_") as tmp:
        run_a, run_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        res_a = train(cfg, loader(), run_a, stop_at_step=4, **kw)
        t_a = time.perf_counter() - t0
        assert res_a["iterations"] == 4, res_a

        # The step-4 checkpoint restores bit for bit: against the arrays
        # in its file, and its params against the snapshot that the step-4
        # evaluation wrote from the in-memory state.
        state_dir = os.path.join(run_a, "train_state")
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
        opt, _ = trainer.make_optimizer(params, 0.0025, 8)
        restored = checkpoint.restore_train_state(
            state_dir, trainer.create_train_state(params, opt))
        assert restored.step == 4
        saved = dict(np.load(os.path.join(state_dir, "state.npz")))
        p_np, m_np, _ = checkpoint.train_state_to_numpy(restored)
        snap = dict(np.load(os.path.join(run_a, "snapshot_model.npz")))
        for k, v in p_np.items():
            assert np.array_equal(v, saved[f"params/{k}"]), k
            assert np.array_equal(v, snap[k]), k
        for k, v in m_np.items():
            assert np.array_equal(v, saved[f"momentum/{k}"]), k
        print(f"step-4 checkpoint restored bit for bit: {len(p_np)} params, "
              f"{len(m_np)} momentum leaves; resume position "
              f"{loader().position_for_step(4)} (epoch, skip)")
        del params, opt, restored

        t0 = time.perf_counter()
        res_b = train(cfg, loader(), run_b, resume_from=state_dir, **kw)
        t_b = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in kernels}
        assert res_b["iterations"] == 8, res_b
        log_a, log_b = read_log(run_a), read_log(run_b)
        for run in (run_a, run_b):
            for name in ("log", "params.yaml", "snapshot_model.npz"):
                assert os.path.exists(os.path.join(run, name)), name
    losses = [e for e in log_a + log_b if "main/loss" in e]
    reports = [e for e in log_a + log_b if "validation/main/map" in e]
    assert [e["iteration"] for e in losses] == [4, 8], losses
    assert [e["iteration"] for e in reports] == [4, 8], reports
    for e in losses:
        for k, v in e.items():
            if k.startswith("main/"):
                assert np.isfinite(v), f"{k} at step {e['iteration']}: {v}"
    require_launched(counts, "train loop (train(), resume, eval)")
    # ms/step: the log's elapsed time at its entry over the 4 steps it
    # covers (run A's includes the first step's warm-up)
    ms_a = losses[0]["elapsed_time"] * 1e3 / 4
    ms_b = losses[1]["elapsed_time"] * 1e3 / 4
    eval_s_img = [t / len(val_ds) for t in ev.seconds]
    print(f"train loop, b2 832x1344 bf16 R-50-C4 COCO: {ms_a:.3f} "
          f"ms/step over steps 1-4 (run A, with warm-up), {ms_b:.3f} ms/step "
          f"over steps 5-8 (run B, resumed); COCO eval "
          f"{[round(x, 4) for x in eval_s_img]} s/img (4 val images each); "
          f"run A {t_a:.2f} s, run B {t_b:.2f} s wall")
    for e in losses:
        print("  losses at step", e["iteration"], {
            k: round(v, 5) for k, v in e.items() if k.startswith("main/")})
    for e in reports:
        print("  report at step", e["iteration"], {
            k: v for k, v in e.items()
            if k.startswith("validation/main/map")})
    return counts, {"loop_ms_per_step_b2": ms_b,
                    "loop_ms_per_step_b2_first4": ms_a,
                    "eval_s_per_img": eval_s_img,
                    "map": [e["validation/main/map"] for e in reports]}


ENTRY_SIZES = (800, 1333)  # the COCO drivers' min_size / max_size
COCO_ROOT_HW = (480, 640)  # the synthetic COCO root's images
SBD_ROOT_HW = (375, 500)  # the synthetic SBD root's images (VOC's shape)


def construct(torch, spec, **kw):
    """``MaskRCNNResNet(pretrained_model=spec)`` at R-50-C4 COCO bf16 on the
    card; returns the model and its construction seconds (import
    included)."""
    from mask_rcnn_tpu_torch import MaskRCNNResNet

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = MaskRCNNResNet(
        n_layers=50, n_fg_class=N_CLASS_FG, min_size=ENTRY_SIZES[0],
        max_size=ENTRY_SIZES[1], anchor_scales=(2, 4, 8, 16, 32),
        compute_dtype="bfloat16", pretrained_model=spec, device="cuda", **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def same_params(torch, a, b):
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    fa, fb = flatten_params(a), flatten_params(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def check_tiles(out, tile_shape, iterations):
    """The visualization report's tiles under ``out``: one
    ``iteration=%08d.jpg`` for each of ``iterations`` and ``latest.jpg``,
    each decoding to an RGB image of ``tile_shape``."""
    from mask_rcnn_tpu_torch.data._image import read_rgb

    vis = os.path.join(out, "visualizations")
    want = sorted([f"iteration={int(i):08d}.jpg" for i in iterations]
                  + ["latest.jpg"])
    assert sorted(os.listdir(vis)) == want, (os.listdir(vis), want)
    for name in want:
        tile = read_rgb(os.path.join(vis, name))
        assert tile.shape == tile_shape, (name, tile.shape, tile_shape)


def drive_dataset_drivers(torch, train_mod, evaluate_mod, argv, n_eval,
                          tile_shape):
    """One dataset's train driver, then its evaluate driver on the log dir
    the first wrote; checks the artifacts, the losses and the
    visualization tiles (each of ``tile_shape``): one a training
    evaluation, and the evaluate driver's ``iteration=00000000.jpg``.
    Returns the train result, the evaluate report and their times."""
    with eval_seconds(torch) as ev, vis_seconds(torch) as vs:
        t0 = time.perf_counter()
        result = train_mod.main(argv)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        out = result["log_dir"]
        for name in ("params.yaml", "log", "snapshot_model.npz"):
            assert os.path.exists(os.path.join(out, name)), name
        entries = read_log(out)
        losses = [e for e in entries if "main/loss" in e]
        assert losses, entries
        for e in losses:
            for k, v in e.items():
                if k.startswith("main/"):
                    assert np.isfinite(v), f"{k} at {e['iteration']}: {v}"
        evals = [e["iteration"] for e in entries
                 if "validation/main/map" in e]
        assert evals, entries
        check_tiles(out, tile_shape, evals)
        n_train_evals = len(ev.seconds)
        n_train_vis = len(vs.seconds)
        assert n_train_vis == n_train_evals, (vs.seconds, ev.seconds)
        report = evaluate_mod.main([out, "--device", "cuda"])
        assert "validation/main/map" in report, report
        assert os.path.exists(os.path.join(
            out, "snapshot_model.npz.eval_result.yaml"))
        check_tiles(out, tile_shape, [0] + evals)
    steps = result["iterations"]
    return result, report, {
        "ms_per_step_b1": (result["elapsed"] - sum(
            ev.seconds[:n_train_evals]) - sum(
            vs.seconds[:n_train_vis])) * 1e3 / steps,
        "steps": steps,
        "train_wall_s": t_train,
        "eval_s_per_img": [t / n_eval for t in ev.seconds],
        "vis_s": vs.seconds,
        "tile_shape": list(tile_shape),
        "losses": {k: v for k, v in losses[-1].items()
                   if k.startswith("main/")},
    }


def drive_entry_points(torch, kernels):
    """Phase 8: the entry points from disk at full width (R-50-C4, 80
    classes, anchor scales (2, 4, 8, 16, 32), min 800 / max 1333), in a
    temporary directory. (a) A seeded Detectron pkl of the COCO shapes,
    the bridge npz of the same tree and the chainer snapshot of it
    (``export_chainer_npz``) give three models whose bf16 predictions on
    the same images are bit-identical. (b) A seeded chainer ImageNet R-50
    npz: 'auto' (through $MASK_RCNN_TPU_IMAGENET_NPZ) gives the same
    params as 'imagenet:<npz>'. (c) The COCO train driver
    (``examples.coco.train.main``) at its defaults, batch 1, float32,
    ``--pretrained-model auto``, 8 steps and one evaluation on the port's
    synthetic 480x640 PNG root (9 minival images), then the evaluate
    driver on its log dir; (d) the VOC/SBD drivers the same way on the
    port's SBD root when a JPEG codec is present. The drivers draw their
    visualization report (phase 10 (a)): the tiles must decode to 3 x 3
    panels of (h, 2w) for COCO, 1 x 2 for SBD's 2 val images. Returns the
    launch counts of the phase and its numbers."""
    import tempfile

    from mask_rcnn_tpu_torch.data import _image
    from mask_rcnn_tpu_torch.data.synthetic import (
        make_synthetic_coco_root,
        make_synthetic_sbd_root,
    )
    from mask_rcnn_tpu_torch.examples.coco import evaluate as coco_evaluate
    from mask_rcnn_tpu_torch.examples.coco import train as coco_train
    from mask_rcnn_tpu_torch.examples.voc import evaluate as voc_evaluate
    from mask_rcnn_tpu_torch.examples.voc import train as voc_train
    from mask_rcnn_tpu_torch.utils.checkpoint import (
        params_to_numpy,
        save_params,
        unflatten_params,
    )
    from mask_rcnn_tpu_torch.utils.detectron_import import (
        export_chainer_npz,
    )
    from tests.torch_import_cases import (
        write_detectron_pkl,
        write_imagenet_npz,
    )

    rng = np.random.RandomState(SEED + 11)
    imgs = [rng.uniform(0, 255, (3, 640, 1066)).astype(np.float32)]
    numbers = {"import_s": {}}
    env_keys = ("MASK_RCNN_TPU_IMAGENET_NPZ", "COCO_ROOT", "SBD_ROOT")
    env_before = {k: os.environ.get(k) for k in env_keys}
    for wrapper in kernels:
        wrapper.launches = 0
    try:
        with tempfile.TemporaryDirectory(prefix="mrcnn_entry_") as tmp:
            # (a) Detectron pkl, bridge npz, chainer snapshot
            pkl = os.path.join(tmp, "model_final.pkl")
            write_detectron_pkl(pkl, n_fg=N_CLASS_FG, n_anchor=15, seed=SEED)
            models = {}
            models["detectron_pkl"], t = construct(torch, pkl)
            numbers["import_s"]["detectron_pkl"] = t
            base = models["detectron_pkl"].params
            npz = os.path.join(tmp, "bridge.npz")
            save_params(npz, base)
            models["bridge_npz"], t = construct(torch, npz)
            numbers["import_s"]["bridge_npz"] = t
            snap = os.path.join(tmp, "snapshot_model.npz")
            export_chainer_npz(unflatten_params(params_to_numpy(base)), snap)
            models["chainer"], t = construct(torch, f"chainer:{snap}")
            numbers["import_s"]["chainer"] = t
            outs = {}
            for name, model in models.items():
                assert same_params(torch, model.params, base), name
                model.score_thresh = 0.0  # 100 detections to compare
                outs[name] = model.predict(imgs)
                check_outputs(imgs, *outs[name])
            ref = outs["detectron_pkl"]
            for name, out in outs.items():
                for a, b in zip(ref, out):
                    for x, y in zip(a, b):
                        assert x.shape == y.shape and np.array_equal(x, y), \
                            f"{name} predicts otherwise than detectron_pkl"
            print(f"entry points (a): Detectron pkl, bridge npz and chainer "
                  f"snapshot models: identical params, bit-identical bf16 "
                  f"predictions at 832x1344 "
                  f"({len(ref[0][0])} detections at score_thresh 0)")
            del models, outs, ref, base

            # (b) ImageNet npz: 'auto' through the environment variable
            imagenet = os.path.join(tmp, "ResNet-50-model.npz")
            write_imagenet_npz(imagenet, seed=SEED)
            os.environ["MASK_RCNN_TPU_IMAGENET_NPZ"] = imagenet
            auto, t = construct(torch, "auto", rng_seed=SEED)
            numbers["import_s"]["auto"] = t
            explicit, t = construct(torch, f"imagenet:{imagenet}",
                                    rng_seed=SEED)
            numbers["import_s"]["imagenet"] = t
            assert same_params(torch, auto.params, explicit.params)
            print("entry points (b): 'auto' ($MASK_RCNN_TPU_IMAGENET_NPZ) "
                  "gives the params of 'imagenet:<npz>'")
            del auto, explicit

            # (c) the COCO drivers on a PNG root
            # 9 minival images: the visualization report's 9 panels of
            # (h, 2w), a 3 x 3 tile
            root = make_synthetic_coco_root(
                os.path.join(tmp, "coco"), n_train=8, n_valminusminival=2,
                n_minival=9, height=COCO_ROOT_HW[0], width=COCO_ROOT_HW[1],
                seed=SEED)
            os.environ["COCO_ROOT"] = root
            h, w = COCO_ROOT_HW
            result, report, coco = drive_dataset_drivers(
                torch, coco_train, coco_evaluate,
                ["--pretrained-model", "auto", "--max-epoch", "0.8",
                 "--eval-interval-epochs", "0.8", "--logs-dir",
                 os.path.join(tmp, "logs"), "--device", "cuda"], n_eval=9,
                tile_shape=(3 * h, 3 * 2 * w, 3))
            assert result["iterations"] == 8, result
            coco["report"] = report
            numbers["coco"] = coco

            # (d) the VOC/SBD drivers, which need a JPEG codec
            numbers["jpeg_decoder"] = _image.jpeg_decoder()
            if numbers["jpeg_decoder"] is None:
                print("entry points (d): no JPEG codec (neither cv2 nor PIL) "
                      "on this machine: the SBD/VOC drivers were not driven")
                numbers["sbd"] = None
            else:
                root = make_synthetic_sbd_root(
                    os.path.join(tmp, "sbd"), n_train=4, n_val=2,
                    height=SBD_ROOT_HW[0], width=SBD_ROOT_HW[1], seed=SEED)
                os.environ["SBD_ROOT"] = root
                h, w = SBD_ROOT_HW
                _, report, sbd = drive_dataset_drivers(
                    torch, voc_train, voc_evaluate,
                    ["--max-epoch", "1", "--logs-dir",
                     os.path.join(tmp, "logs_sbd"), "--device", "cuda"],
                    n_eval=2, tile_shape=(h, 2 * 2 * w, 3))
                sbd["report"] = report
                numbers["sbd"] = sbd
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in kernels}
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require_launched(counts, "entry points from disk (pkl, npz, chainer, "
                     "auto, COCO train and evaluate drivers)")
    print("entry points, R-50-C4 COCO: import s per spec "
          f"{ {k: round(v, 3) for k, v in numbers['import_s'].items()} }; "
          f"COCO train driver {numbers['coco']['ms_per_step_b1']:.3f} "
          f"ms/step (batch 1, float32, 8 steps at 800x1067, evaluation "
          f"and visualization excluded), evaluation "
          f"{[round(x, 4) for x in numbers['coco']['eval_s_per_img']]} "
          f"s/img (9 minival images: in training, then the evaluate "
          f"driver); JPEG decoder {numbers['jpeg_decoder']}")
    print("phase 10 (a), the drivers' visualization report (VisReport, "
          "9 panels at score threshold 0.7, a "
          f"{numbers['coco']['tile_shape']} tile): "
          f"{[round(x, 4) for x in numbers['coco']['vis_s']]} s after "
          "each evaluation (in training, then the evaluate driver), beside "
          f"{[round(x, 4) for x in numbers['coco']['eval_s_per_img']]} "
          "s/img of evaluation")
    return counts, numbers


OVERFIT_STEPS = 400  # check_train_overfit.py's own count
OVERFIT_RATIO = 0.75  # the last logged loss at most this share of the first


def demo_images(rng, jpeg):
    """Phase 10's demo inputs: (name, (H, W, 3) uint8) of a landscape and a
    portrait PNG and, where a codec imports, a JPEG; noise with coloured
    rectangles."""
    shapes = [("land.png", 480, 640), ("port.png", 640, 480)]
    if jpeg:
        shapes.append(("photo.jpg", 427, 640))
    out = []
    for name, h, w in shapes:
        img = rng.randint(0, 100, (h, w, 3)).astype(np.uint8)
        for _ in range(3):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            img[y:y + h // 4, x:x + w // 4] = rng.randint(100, 256, 3)
        out.append((name, img))
    return out


def drive_last_mile(torch, serve_kernels, train_kernels):
    """Phase 10: the user's last mile at full width (R-50-C4, 80 classes,
    anchor scales (2, 4, 8, 16, 32), min 800 / max 1333), in a temporary
    directory. (a) is phase 8's drivers' visualization report. (b) The
    seeded weights as a log dir (``save_params`` + ``params.yaml``), and a
    seeded Detectron pkl through ``examples/coco/convert_caffe2.py`` as a
    second; ``examples/demo.py`` on the first at score threshold 0 over a
    PNG of each orientation and a JPEG where a codec imports: numbered
    outputs of each input's size, each unlike its input. (c)
    ``examples/coco/speedtest.py`` at its defaults (bf16, a 640x1066
    random image) with 20 requests, plain and ``--pipeline``. (d)
    ``examples/summarize_logs.py`` over the phase's logs: a row for each
    log dir. (b)-(d) must launch every kernel of ``serve_kernels``. (e)
    ``examples/check_train_overfit.py``'s function at its own
    configuration (2 classes, 256x320, float32, batch 2): 400 steps, every
    logged loss finite and the last at most 0.75 of the first; it must
    launch every kernel of ``train_kernels``. Returns the two windows'
    launch counts and the phase's numbers."""
    import tempfile

    from mask_rcnn_tpu_torch import MaskRCNNResNet
    from mask_rcnn_tpu_torch.data import _image
    from mask_rcnn_tpu_torch.examples import demo, summarize_logs
    from mask_rcnn_tpu_torch.examples.check_train_overfit import run_overfit
    from mask_rcnn_tpu_torch.examples.coco import convert_caffe2, speedtest
    from mask_rcnn_tpu_torch.utils.checkpoint import save_params
    from mask_rcnn_tpu_torch.utils.logging import dump_params
    from tests.torch_import_cases import write_detectron_pkl

    t_phase = time.perf_counter()
    numbers = {}
    for wrapper in serve_kernels:
        wrapper.launches = 0
    with tempfile.TemporaryDirectory(prefix="mrcnn_last_mile_") as tmp:
        # (b) two log dirs, then the demo on the seeded one
        logs = os.path.join(tmp, "logs")
        seeded = os.path.join(logs, "seeded")
        os.makedirs(seeded)
        model, _ = construct(torch, None, rng_seed=SEED)
        save_params(os.path.join(seeded, "snapshot_model.npz"), model.params)
        dump_params(seeded, {"dataset": "coco", "model": "resnet50",
                             "model_config": dict(
                                 n_fg_class=N_CLASS_FG, n_layers=50,
                                 min_size=ENTRY_SIZES[0],
                                 max_size=ENTRY_SIZES[1],
                                 anchor_scales=[2, 4, 8, 16, 32],
                                 roi_size=14, pooling="align")})
        del model
        pkl = os.path.join(tmp, "model_final.pkl")
        write_detectron_pkl(pkl, n_fg=N_CLASS_FG, n_anchor=15, seed=SEED)
        convert_caffe2.main([pkl, "--out",
                             os.path.join(logs, "R-50-C4_x1_caffe2")])

        rng = np.random.RandomState(SEED + 10)
        inputs = demo_images(rng, _image.jpeg_decoder() is not None)
        paths = []
        for name, img in inputs:
            path = os.path.join(tmp, name)
            if name.endswith(".png"):
                _image.write_png(path, img)
            else:
                _image.write_jpeg(path, img)
            paths.append(path)
        out = os.path.join(tmp, "demo_out")
        with CallSeconds(torch, MaskRCNNResNet, "predict") as pred:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = demo.main([seeded, "--images", *paths,
                                 "--score-thresh", "0", "--out", out,
                                 "--device", "cuda"])
            t_demo = time.perf_counter() - t0
        names = [os.path.basename(p) for p in written]
        assert names == [f"{i:03d}_{os.path.basename(p)}"
                         for i, p in enumerate(paths)], names
        for src, dst in zip(paths, written):
            a, b = _image.read_rgb(src), _image.read_rgb(dst)
            assert a.shape == b.shape, (src, a.shape, b.shape)
            assert (a != b).any(), f"{dst} equals its input"
        n = len(paths)
        numbers["demo"] = {
            "images": names, "wall_s": t_demo,
            "ms_per_img": t_demo * 1e3 / n,
            "predict_ms_per_img": sum(pred.seconds) * 1e3 / n}
        print(f"phase 10 (b), demo (float32: a log dir's model) on {n} "
              f"images {[img.shape for _, img in inputs]}: {t_demo:.3f} s "
              f"in all, {t_demo * 1e3 / n:.3f} ms/img with the model build, "
              f"drawing and writing; predict "
              f"{numbers['demo']['predict_ms_per_img']:.3f} ms/img "
              f"(chunks of 2: {[round(x, 4) for x in pred.seconds]} s)")

        # (c) speedtest at its defaults, 20 requests
        numbers["speedtest"] = {
            mode: speedtest.main(["--n-times", "20", "--device", "cuda"]
                                 + flags)["ms"]
            for mode, flags in (("plain", []), ("pipeline", ["--pipeline"]))}

        # (d) summarize_logs over the phase's logs
        rows = summarize_logs.main([logs])
        assert [r["log_dir"] for r in rows] == ["R-50-C4_x1_caffe2",
                                                "seeded"], rows
        torch.cuda.synchronize()
        serve_counts = {w.__name__: w.launches for w in serve_kernels}
        require_launched(serve_counts, "last mile: demo, speedtest, "
                         "summarize_logs")

    # (e) the overfit check at its own configuration
    for wrapper in train_kernels:
        wrapper.launches = 0
    overfit = run_overfit(OVERFIT_STEPS, device="cuda", log_every=50)
    torch.cuda.synchronize()
    train_counts = {w.__name__: w.launches for w in train_kernels}
    require_launched(train_counts, "last mile: the overfit check")
    losses = [m["loss"] for _, m in overfit["losses"]]
    for it, m in overfit["losses"]:
        for k, v in m.items():
            assert np.isfinite(v), f"overfit step {it}: {k} = {v}"
    ratio = overfit["last"] / overfit["first"]
    numbers["overfit"] = {
        "steps": OVERFIT_STEPS, "seconds": overfit["seconds"],
        "ms_per_step": overfit["seconds"] * 1e3 / OVERFIT_STEPS,
        "loss": [(it, round(m["loss"], 4)) for it, m in overfit["losses"]],
        "last_over_first": ratio,
        "detections": len(overfit["detections"][0])}
    print(f"phase 10 (e), overfit (2 classes, 256x320, float32, batch 2): "
          f"{OVERFIT_STEPS} steps in {overfit['seconds']:.3f} s "
          f"({numbers['overfit']['ms_per_step']:.3f} ms/step), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (ratio {ratio:.4f}, limit "
          f"{OVERFIT_RATIO}), {numbers['overfit']['detections']} detections "
          "on image 0 at score threshold 0.3")
    assert ratio <= OVERFIT_RATIO, \
        f"the overfit loss fell to {ratio:.4f} of its first value only"
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10 (b)-(e): {numbers['seconds']:.3f} s")
    return serve_counts, train_counts, numbers


def kernel_group(name):
    """Coarse family of a CUDA kernel's name, for the profile's table."""
    low = name.lower()
    for group, keys in (
        ("K10 stem", ("stem_f32_kernel", "stem_bf16_kernel")),
        ("K1 roi_align fwd", ("roi_align_fwd",)),
        ("K7 roi_align bwd", ("roi_align_bwd",)),
        ("K5 crop_resize fwd", ("crop_resize_fwd",)),
        ("K11 crop_resize bwd", ("crop_resize_bwd",)),
        ("K6 roi_pool fwd", ("roi_pool_fwd",)),
        ("K12 roi_pool bwd", ("roi_pool_bwd",)),
        ("K3 decode select", ("decode_select",)),
        ("K3 nms_small", ("nms_small", "nms_tiled_kernel<256>")),
        ("K2 nms", ("nms_tiled",)),
        ("K9a/K9b target creators", ("anchor_targets", "proposal_targets")),
        ("conv/matmul (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass",
                                         "sm90", "wgrad", "dgrad", "nchw",
                                         "nhwc", "nvjet")),
        ("optimizer (foreach)", ("multi_tensor", "foreach")),
        ("sort/top-k", ("sort", "radix", "topk")),
        ("reduce", ("reduce",)),
        ("copy/cast", ("copy", "memcpy", "memset", "cat")),
        ("elementwise", ("elementwise", "vectorized")),
    ):
        if any(k in low for k in keys):
            return group
    return "other"


def profile_train(torch, step, state, batch):
    """Device time of two train steps by kernel family (profiler); returns
    the device ms a step."""
    box = [state]

    def run():
        box[0], _ = step(box[0], batch, SEED)

    events = device_events(torch, run, iters=2)
    print_families(families(events), "2 train steps (per step)")
    print("top kernels (ms per step, launches, name):")
    for name, cnt, ms in sorted(events, key=lambda e: -e[2])[:12]:
        print(f"  {ms:8.3f} {cnt:5g}  {name[:110]}")
    return sum(ev[2] for ev in events)


def check_outputs(imgs, bboxes, masks, labels, scores):
    assert len(bboxes) == len(imgs)
    for img, b, m, lab, s in zip(imgs, bboxes, masks, labels, scores):
        h, w = img.shape[1:]
        r = len(b)
        assert b.shape == (r, 4) and m.shape == (r, h, w), (b.shape, m.shape)
        assert lab.shape == (r,) and s.shape == (r,)
        assert np.isfinite(b).all() and np.isfinite(s).all()
        assert (b[:, 0] >= 0).all() and (b[:, 1] >= 0).all()
        assert (b[:, 2] <= h).all() and (b[:, 3] <= w).all()
        assert (b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all()
        assert m.dtype == bool
        if r:
            assert lab.min() >= 0 and lab.max() < N_CLASS_FG
            assert (s >= 0).all() and (s <= 1).all()


AB_CASES = ("k1_bf16_1000", "k1_bf16_100", "k1_f32_1000", "k4_bf16_2000",
            "k2_6000_1000", "k2_2x12000_2000", "k7_bf16_2x512",
            "k13_bf16_1300_700", "k10_bf16_b1", "k10_bf16_b2", "k10_f32_b1",
            "targets_b2", "decode_b1", "decode_b1_t0", "k12_bf16_2x512",
            "k6_bf16_1000", "k6_bf16_100", "k11_bf16_2x512",
            "k11_bf16_2x512_s2", "k5_bf16_1000", "k5_bf16_100",
            "k5_f32_1000", "predict_b1", "align_step_b2")
# Cases whose kernels sum with float32 atomics: the two checkouts' outputs
# differ in their last bits from run to run, so the A/B prints the largest
# difference instead of bit-identity.
AB_ATOMIC = ("k7_bf16_2x512", "k13_bf16_1300_700", "k12_bf16_2x512",
             "k11_bf16_2x512", "k11_bf16_2x512_s2")


def ab_inputs(torch, path):
    """The A/B cases' inputs at phase 2's shapes, from fixed seeds, saved
    with ``torch.save``: (1, 52, 84, 1024) features with 1000 and 100
    proposal-like rois (K1), (2, 52, 84, 1024) features with 1300 / 700 flat
    rois (K4, and K13 with a (2000, 7, 7, 1024) gradient), 6000 and
    (2, 12000) score-sorted boxes with invalid rows (K2), 2 x 512 rois and
    a (2, 512, 7, 7, 1024) gradient (K7; the gradients are drawn on the
    card from a seeded generator by :func:`ab_worker`), the stem's params
    and (2, 832, 1344, 3) images (K10); a synthetic train batch of 2 at
    832x1344 with 8 gts and packed masks an image, the 65520 anchors of its
    52x84 grid, 2000 proposal-like boxes an image (200 of them jittered
    around the gts) and the creators' sampling priorities (the target
    creators; the batch also feeds the align train step); the decode's
    inputs at the serving shape (:func:`decode_arrays`, batch 1; its
    sizes and scales also feed the predict step on the first image); and
    relu'd (2, 52, 84, 1024) features with 2 x 512 flat rois (K12, with a
    (1024, 14, 14, 1024) gradient drawn on the card; K11 with another, dense
    and zeroed on every odd py or odd px; K6 on the first image's features
    with the 1000 and 100 rois of K1); and phase 2's K5 inputs, drawn as
    :func:`check_pool_kernels` draws them (:func:`pool_features`,
    :func:`pool_rois`): relu'd (1, 52, 84, 1024) features with 1000 and 100
    flat rois."""
    rng = np.random.RandomState(SEED)
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16
    t = torch.from_numpy
    x = {"feats": t(rng.randn(1, fh, fw, 1024).astype(np.float32)),
         "feats2": t(rng.randn(2, fh, fw, 1024).astype(np.float32))}
    for r in (1000, 100):
        boxes = proposal_like_boxes(rng, r, *TRAIN_HW)
        boxes[-r // 20:] = 0.0  # zero-padded slots, as proposals have
        x[f"rois_{r}"] = t(boxes[None])
    flat = np.concatenate([proposal_like_boxes(rng, k, *TRAIN_HW)
                           for k in FLAT_SPLIT])
    flat_idx = np.repeat(np.arange(2, dtype=np.int32), FLAT_SPLIT)
    perm = rng.permutation(len(flat_idx))
    x["flat_rois"], x["flat_idx"] = t(flat[perm]), t(flat_idx[perm])
    for b, n in ((1, 6000), (2, 12000)):
        boxes = np.stack([proposal_like_boxes(rng, n, *TRAIN_HW)
                          for _ in range(b)])
        valid = (rng.rand(b, n) > 0.02) & (np.arange(n) < n - 100)
        x[f"nms_boxes_{n}"], x[f"nms_valid_{n}"] = t(boxes), t(valid)
    x["rois_2x512"] = t(np.stack([proposal_like_boxes(rng, 512, *TRAIN_HW)
                                  for _ in range(2)]))
    gen = torch.Generator().manual_seed(SEED)
    x["stem"] = stem_params(torch, gen)
    x["images"] = torch.rand((2, *TRAIN_HW, 3), generator=gen) * 255 - 120
    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        make_anchors,
    )

    batch = make_synthetic_train_batch(2, *TRAIN_HW, rng)
    x.update({f"batch_{k}": t(v) for k, v in batch.items()})
    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG,
                         anchor_scales=(2, 4, 8, 16, 32))
    x["anchors"] = t(make_anchors(cfg, fh, fw))
    boxes = np.stack([proposal_like_boxes(rng, 2000, *TRAIN_HW)
                      for _ in range(2)])
    near = batch["bbox"][:, rng.randint(0, 8, 200)] + rng.randn(2, 200, 4) * 8
    boxes[:, :200] = np.clip(near, 0, [*TRAIN_HW, *TRAIN_HW])
    x["t_rois"] = t(boxes.astype(np.float32))
    x["t_roi_valid"] = t(rng.rand(2, 2000) > 0.02)
    for k, a in zip(("roi", "roi_valid", "cls_loc", "score", "sizes",
                     "scales"), decode_arrays(rng, 1)):
        x[f"dec_{k}"] = t(a)
    x["pool_feats"] = t(np.maximum(rng.randn(2, fh, fw, 1024), 0)
                        .astype(np.float32))
    flat = np.concatenate([proposal_like_boxes(rng, TRAIN_ROIS, *TRAIN_HW)
                           for _ in range(2)])
    x["pool_rois"] = t(flat)
    x["pool_idx"] = t(np.repeat(np.arange(2, dtype=np.int32), TRAIN_ROIS))
    rng2 = np.random.RandomState(SEED + 2)
    x["k5_feats"] = t(pool_features(rng2, 1))
    for r in SERVE_ROIS:
        x[f"k5_rois_{r}"], x[f"k5_idx_{r}"] = map(t, pool_rois(rng2, 1, r))
    s, p = len(x["anchors"]), 2000 + 8
    for k, shape in (("a_pos", (2, s)), ("a_neg", (2, s)), ("p_pos", (2, p)),
                     ("p_neg", (2, p))):
        x[f"pri_{k}"] = torch.rand(shape, generator=gen)
    torch.save(x, path)


def ab_targets(x):
    """Both target creators of the worker's checkout
    (``models/targets.py``) on the A/B inputs, with given priorities."""
    from mask_rcnn_tpu_torch.models import targets as mt

    a = mt.anchor_targets(x["batch_bbox"], x["batch_bbox_valid"],
                          x["anchors"], TRAIN_HW, mt.AnchorTargetConfig(),
                          priorities=(x["pri_a_pos"], x["pri_a_neg"]))
    p = mt.proposal_targets(x["t_rois"], x["t_roi_valid"], x["batch_bbox"],
                            x["batch_label"], x["batch_bbox_valid"],
                            x["batch_mask"], mt.ProposalTargetConfig(),
                            (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2),
                            mask_packed=True,
                            priorities=(x["pri_p_pos"], x["pri_p_neg"]))
    return (*a, *p)


def ab_step(torch, x):
    """The worker's checkout's align train step at b2 832x1344 bf16
    (R-50-C4 COCO, seeded random weights) on the A/B batch, the sampling
    drawn from the step's seeded generator. Returns a function that runs
    one more step, and the first step's losses."""
    from mask_rcnn_tpu_torch import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        init_params,
    )

    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
                         anchor_scales=(2, 4, 8, 16, 32),
                         compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         torch.device("cuda"))
    opt, _ = make_optimizer(params, 0.02, 1000)
    state = [create_train_state(params, opt)]
    step = make_train_step(cfg, opt)
    batch = {k[len("batch_"):]: v for k, v in x.items()
             if k.startswith("batch_")}

    def run():
        state[0], metrics = step(state[0], batch, SEED)
        return metrics

    first = run()
    return run, (torch.stack(list(first.values())).cpu(),)


def ab_worker(tree, inputs, out):
    """One side of the A/B: with ``tree``'s package, build its kernels, run
    each case once for its output and time it (CUDA events, 3 warm-up and
    20 timed calls; and the device's time and activities from the
    profiler, over 10 calls; the align train step after its first step: 2
    warm-up and 5 timed steps, 2 profiled); save outputs and times."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from mask_rcnn_tpu_torch.models import mask_rcnn, resnet
    from mask_rcnn_tpu_torch.ops import _kernels, nms, roi_align

    assert os.path.dirname(_kernels.__file__).startswith(
        os.path.abspath(tree)), _kernels.__file__
    _kernels.lib()
    x = torch.load(inputs)
    params = x.pop("stem")
    step_run, step_first = ab_step(torch, {k: v.cuda() for k, v in x.items()
                                           if k.startswith("batch_")})
    stem = {dt: {k: {m: t.cuda().to(dt) for m, t in v.items()}
                 for k, v in params.items()}
            for dt in (torch.bfloat16, torch.float32)}
    x = {k: v.cuda() for k, v in x.items()}
    bf, bf2 = x["feats"].bfloat16(), x["feats2"].bfloat16()
    img = {dt: x["images"].to(dt) for dt in (torch.bfloat16, torch.float32)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g7 = torch.randn((2, 512, 7, 7, 1024), generator=gen,
                     device="cuda").bfloat16()
    g13 = torch.randn((2000, 7, 7, 1024), generator=gen,
                      device="cuda").bfloat16()
    g12 = torch.randn((2 * TRAIN_ROIS, 14, 14, 1024), generator=gen,
                      device="cuda").bfloat16()
    g11 = torch.randn((2 * TRAIN_ROIS, 14, 14, 1024), generator=gen,
                      device="cuda").bfloat16()
    g11_s2 = g11.clone()
    g11_s2[:, 1::2] = 0.0
    g11_s2[:, :, 1::2] = 0.0
    pool_feats = x["pool_feats"].bfloat16()
    pool_feats1 = pool_feats[:1]
    k5_feats = x["k5_feats"].bfloat16()
    idx0 = {r: torch.zeros(r, dtype=torch.int32, device="cuda")
            for r in (1000, 100)}
    dec_cfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
        anchor_scales=(2, 4, 8, 16, 32), compute_dtype="bfloat16")
    dec_cfg_t0 = dataclasses.replace(dec_cfg, score_thresh=0.0)
    dec = [x[f"dec_{k}"] for k in ("roi", "roi_valid", "cls_loc", "score",
                                   "sizes", "scales")]
    pred_params = mask_rcnn.init_params(
        dec_cfg, torch.Generator().manual_seed(SEED), torch.device("cuda"))
    fhw = (TRAIN_HW[0] // 16, TRAIN_HW[1] // 16)
    args = (7, 1 / 16, 0, 2)
    calls = {
        "k1_bf16_1000": lambda: roi_align.roi_align_grouped(
            bf, x["rois_1000"], *args),
        "k1_bf16_100": lambda: roi_align.roi_align_grouped(
            bf, x["rois_100"], *args),
        "k1_f32_1000": lambda: roi_align.roi_align_grouped(
            x["feats"], x["rois_1000"], *args),
        "k4_bf16_2000": lambda: roi_align.roi_align(
            bf2, x["flat_rois"], x["flat_idx"], *args),
        "k2_6000_1000": lambda: nms.nms_blocked(
            x["nms_boxes_6000"], x["nms_valid_6000"], 0.7, 1000),
        "k2_2x12000_2000": lambda: nms.nms_blocked(
            x["nms_boxes_12000"], x["nms_valid_12000"], 0.7, 2000),
        "k7_bf16_2x512": lambda: roi_align.roi_align_grouped_backward(
            g7, x["rois_2x512"], fhw, *args[1:]),
        "k13_bf16_1300_700": lambda: roi_align.roi_align_backward(
            g13, x["flat_rois"], x["flat_idx"], (2, *fhw), *args[1:]),
        "k10_bf16_b1": lambda: resnet.stem_forward(
            stem[torch.bfloat16], img[torch.bfloat16][:1]),
        "k10_bf16_b2": lambda: resnet.stem_forward(
            stem[torch.bfloat16], img[torch.bfloat16]),
        "k10_f32_b1": lambda: resnet.stem_forward(
            stem[torch.float32], img[torch.float32][:1]),
        "targets_b2": lambda: ab_targets(x),
        "decode_b1": lambda: mask_rcnn.decode(dec_cfg, *dec),
        "decode_b1_t0": lambda: mask_rcnn.decode(dec_cfg_t0, *dec),
        "k12_bf16_2x512": lambda: roi_align.roi_pool_backward(
            g12, pool_feats, x["pool_rois"], x["pool_idx"], 1 / 16),
        "k6_bf16_1000": lambda: roi_align.roi_pool(
            pool_feats1, x["rois_1000"][0], idx0[1000], 14, 1 / 16),
        "k6_bf16_100": lambda: roi_align.roi_pool(
            pool_feats1, x["rois_100"][0], idx0[100], 14, 1 / 16),
        "k11_bf16_2x512": lambda: roi_align.crop_and_resize_backward(
            g11, x["pool_rois"], x["pool_idx"], (2, *fhw), 1 / 16),
        "k11_bf16_2x512_s2": lambda: roi_align.crop_and_resize_backward(
            g11_s2, x["pool_rois"], x["pool_idx"], (2, *fhw), 1 / 16),
        "k5_bf16_1000": lambda: roi_align.crop_and_resize(
            k5_feats, x["k5_rois_1000"], x["k5_idx_1000"], 14, 1 / 16),
        "k5_bf16_100": lambda: roi_align.crop_and_resize(
            k5_feats, x["k5_rois_100"], x["k5_idx_100"], 14, 1 / 16),
        "k5_f32_1000": lambda: roi_align.crop_and_resize(
            x["k5_feats"], x["k5_rois_1000"], x["k5_idx_1000"], 14, 1 / 16),
        "predict_b1": lambda: tuple(mask_rcnn.predict_step(
            pred_params, dec_cfg, img[torch.float32][:1],
            x["dec_sizes"], x["dec_scales"]).values()),
    }
    outputs, ms, dev_ms, launches = {}, {}, {}, {}
    with torch.no_grad():
        for name in AB_CASES[:-1]:
            got = calls[name]()
            got = got if isinstance(got, tuple) else (got,)
            outputs[name] = tuple(g.cpu() for g in got)
            ms[name] = cuda_ms(torch, calls[name])
            dev_ms[name], launches[name] = device_profile(torch, calls[name])
        serve_families = families(device_events(torch, calls["predict_b1"],
                                                iters=3))
    name = AB_CASES[-1]
    outputs[name] = step_first
    ms[name] = cuda_ms(torch, step_run, warmup=2, iters=5)
    dev_ms[name], launches[name] = device_profile(torch, step_run, iters=2)
    torch.save({"outputs": outputs, "ms": ms, "device_ms": dev_ms,
                "launches": launches, "serve_families": serve_families}, out)


def run_against(torch, other) -> int:
    """K1, K2, K4, K7, K13, K10, the two target creators (``targets_b2``:
    ``models/targets.py::anchor_targets`` + ``proposal_targets``),
    ``models/mask_rcnn.py::decode`` at the serving shape (``decode_b1`` at
    score_thresh 0.05, ``decode_b1_t0`` at 0), K12 (``k12_bf16_2x512``),
    K6 (``k6_bf16_1000``, ``k6_bf16_100``), K11 on a dense gradient and on
    res5's stride-2 one (``k11_bf16_2x512``, ``k11_bf16_2x512_s2``), K5 on
    phase 2's inputs (``k5_bf16_1000``, ``k5_bf16_100``, ``k5_f32_1000``),
    the align ``predict_step`` at batch 1, 832x1344 bf16 (``predict_b1``,
    with its device time by kernel family) and the align train step
    (``align_step_b2``; its output is the first step's losses) of this
    checkout against ``other``'s: the same inputs
    (:func:`ab_inputs`) through each checkout's package in its own
    process, in the order other, this, this, other. Prints each run's
    times (CUDA events and the profiler's device time) and device
    activities per call, whether this checkout's outputs equal the other's
    bit for bit (where not, how many values of the first output differ and
    by how much; for the atomic kernels K7, K13, K12 and K11 the largest
    difference, against the largest value), and one JSON line."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(other), "this": here}
    card = nvidia_smi()
    print(card)
    runs, outputs = [], {}
    with tempfile.TemporaryDirectory(prefix="mrcnn_ab_") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        ab_inputs(torch, inputs)
        for i, side in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ab-worker", trees[side], inputs, out],
                           check=True, cwd=trees[side])
            res = torch.load(out)
            outputs.setdefault(side, res["outputs"])
            runs.append({"tree": side, "ms": res["ms"],
                         "device_ms": res["device_ms"],
                         "launches": res["launches"],
                         "serve_families": res["serve_families"]})
            print(f"run {i} ({side}, {trees[side]}): " + ", ".join(
                f"{k} {v:.4f} ms (device {res['device_ms'][k]:.4f}, "
                f"{res['launches'][k]:g} launches)"
                for k, v in res["ms"].items()))
            print_families(res["serve_families"],
                           f"run {i} ({side}): align predict_step at batch 1, "
                           "832x1344 bf16")
    identical, differ = {}, {}
    for name in AB_CASES:
        pairs = list(zip(outputs["other"][name], outputs["this"][name]))
        identical[name] = all(torch.equal(p, q) for p, q in pairs)
        line = f"{name}: identical to the other checkout's {identical[name]}"
        if not identical[name]:
            p, q = (v.float() for v in pairs[0])
            diff = (q - p).abs()
            differ[name] = {"values": int((diff > 0).sum()),
                            "of": diff.numel(),
                            "max_abs": diff.max().item(),
                            "max_abs_over_top": (diff.max()
                                                 / p.abs().max()).item()}
            line += (f" ({differ[name]['values']} of {diff.numel()} values "
                     f"differ, max |diff| {differ[name]['max_abs']:.3e}, "
                     f"{differ[name]['max_abs_over_top']:.3e} of the largest"
                     f"{'; float32 atomics' if name in AB_ATOMIC else ''})")
        print(line)
    print(json.dumps({"card": card, "identical": identical,
                      "differ": differ, "runs": runs}))
    return 0


# ---- Phase 11: the profiling layer and the last two checks ---------------

# The profiling tools' timing depth in the smoke (their shapes, dtypes and
# configurations are their defaults; the full depth runs outside it).
PROFILE_DEPTH = {"iters": 2, "reps": 3}
# (b) must launch these: K10, K1, K2, K3, K4, K7, K9a, K9b, K13.
PROFILED_KERNELS = ("stem_forward", "roi_align_grouped", "nms_blocked",
                    "decode_select", "roi_align",
                    "roi_align_grouped_backward", "anchor_targets",
                    "proposal_targets", "roi_align_backward")


def run_module_in_process(run):
    """A stand-in for ``subprocess.run`` that runs ``python -m <module>
    <args>`` in this process (``runpy``, as ``-m`` does, with ``env``'s
    variables set and ``sys.argv`` the command's) and returns its exit code
    and its output; any other command goes to ``run``. Phase 11 (d) runs
    ``check_dtype_parity``'s rehearsals and their drivers so: each process
    would take ~15 s to start and reach the card."""
    import contextlib
    import io
    import runpy

    def in_process(cmd, *args, env=None, **kwargs):
        if list(cmd[:2]) != [sys.executable, "-m"]:
            return run(cmd, *args, env=env, **kwargs)
        saved_env, saved_argv = dict(os.environ), sys.argv
        if env is not None:
            os.environ.update(env)
        sys.argv = [cmd[2], *cmd[3:]]
        out, code = io.StringIO(), 0
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(out):
                runpy.run_module(cmd[2], run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = (e.code if isinstance(e.code, int)
                    else int(e.code is not None))
            if not isinstance(e.code, (int, type(None))):
                out.write(f"{e.code}\n")
        finally:
            sys.argv = saved_argv
            os.environ.clear()
            os.environ.update(saved_env)
        return subprocess.CompletedProcess(cmd, code, out.getvalue(), None)

    return in_process


def drive_profiling(torch, train_align, kernel_ms):
    """Phase 11: (a) ``utils/profiling.py::time_fn_chained`` on K1 (1000
    rois) and K2 (6000 -> 1000) against the profiler's device time of 10
    plain calls of the same call and phase 2's CUDA-event time
    ``kernel_ms`` (within 25% of each), and ``time_train_steps_chained`` on the align
    b2 bf16 step beside phase 5's CUDA-event and profiled device ms; (b)
    the four profiling tools at their default shapes (``mfu_report`` R-50,
    ``train_profile`` bf16 and float32, ``head_profile``,
    ``bench_align_variants``; timing depth :data:`PROFILE_DEPTH`): every
    row finite with positive times, every kernel a row launched reported
    work (``ops/costs.py``), and :data:`PROFILED_KERNELS` launched; (c)
    ``check_eval_memory`` at ``--images 200 --raw`` and ``--images 50`` in
    fresh processes, RSS bounded; (d) ``check_dtype_parity`` at its tiny
    settings on the card, its rehearsals and their drivers in this process
    (:func:`run_module_in_process`). Returns (b)'s launch counts and the
    numbers."""
    import contextlib
    import io
    import tempfile
    import unittest.mock

    from mask_rcnn_tpu_torch import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.examples import (
        _profile_common,
        bench_align_variants,
        check_dtype_parity,
        head_profile,
        mfu_report,
        train_profile,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        MaskRCNNConfig,
        init_params,
    )
    from mask_rcnn_tpu_torch.ops import nms, roi_align
    from mask_rcnn_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    numbers, fails = {}, []
    t_phase = time.perf_counter()

    # (a) the timing helpers against the profiler
    rng = np.random.RandomState(SEED)
    feats = torch.from_numpy(
        rng.randn(1, 52, 84, 1024).astype(np.float32)).to(dev).bfloat16()
    boxes = proposal_like_boxes(rng, 1000, 832, 1344)
    boxes[-50:] = 0.0
    rois = torch.from_numpy(boxes[None]).to(dev)
    nms_boxes = torch.from_numpy(
        proposal_like_boxes(rng, 6000, 832, 1344)[None]).to(dev)
    nms_valid = torch.from_numpy(
        (rng.rand(1, 6000) > 0.02) & (np.arange(6000) < 5900)).to(dev)
    for name, fn, feed, phase2 in (
        ("K1 roi_align_grouped, 1000 rois",
         lambda f: roi_align.roi_align_grouped(f, rois, 7, 1 / 16, 0, 2),
         feats, kernel_ms["roi_align_grouped"]),
        ("K2 nms_blocked, 6000 -> 1000",
         lambda b: nms.nms_blocked(b, nms_valid, 0.7, 1000), nms_boxes,
         kernel_ms["nms_blocked"]),
    ):
        # one capture each, checked for lost activities: a short capture
        # raises and fails the phase; what each lost outside its runs is
        # printed
        try:
            chained = profiling.time_fn_chained(fn, feed, reps=20, iters=3)
            captures = [dict(profiling.LAST_CAPTURE)]
            prof = profiling.device_busy_ms(lambda: fn(feed), 1, 10)
            captures.append(dict(profiling.LAST_CAPTURE))
        except RuntimeError as e:
            fails.append(f"(a) {name}: {e}")
            print(f"phase 11 (a) {name}: {e}")
            continue
        numbers[name] = {"chained_device_ms": chained,
                         "profiler_device_ms": prof, "phase2_ms": phase2,
                         "captures": captures}
        rel = max(abs(chained - prof) / prof, abs(chained - phase2) / phase2)
        print(f"phase 11 (a) {name}: time_fn_chained {chained:.4f} ms, "
              f"profiler device time of 10 plain calls {prof:.4f} ms, "
              f"phase 2 {phase2:.4f} ms (CUDA events): {rel:.1%} apart at "
              f"most, limit 25%; the two captures: {captures}")
        if not rel <= 0.25:
            fails.append(f"(a) {name}: {chained:.4f} vs {prof:.4f} and "
                         f"{phase2:.4f} ms")

    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
                         anchor_scales=(2, 4, 8, 16, 32),
                         compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    opt, _ = make_optimizer(params, 0.02, 1000)
    state = create_train_state(params, opt)
    batch = train_batch(torch, 2, *TRAIN_HW, dev)
    step = make_train_step(cfg, opt)
    start = state.step
    try:
        chained = profiling.time_train_steps_chained(step, state, batch,
                                                     SEED, reps=4, iters=2)
    except RuntimeError as e:  # a short capture
        fails.append(f"(a) align step: {e}")
        chained = float("nan")
    assert state.step == start + 12, (start, state.step)
    numbers["align_step_b2"] = {
        "chained_device_ms": chained,
        "phase5_events_ms": train_align["train_ms_per_step_b2"],
        "phase5_profiled_device_ms": train_align["device_ms_per_step"]}
    print(f"phase 11 (a) align b2 bf16 step: time_train_steps_chained "
          f"{chained:.3f} ms of device time a step; phase 5: "
          f"{train_align['train_ms_per_step_b2']:.3f} ms (CUDA events), "
          f"{train_align['device_ms_per_step']:.3f} ms of profiled device "
          f"work; the capture: {profiling.LAST_CAPTURE}")
    if not (np.isfinite(chained) and chained > 0):
        fails.append(f"(a) align step: {chained}")
    del params, opt, state, batch, step

    # (b) the four profiling tools
    wrappers = _profile_common.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    tools = {
        "mfu_report": lambda: mfu_report.run(
            iters=PROFILE_DEPTH["iters"], reps=PROFILE_DEPTH["reps"],
            step_reps=PROFILE_DEPTH["reps"]),
        "train_profile bf16": lambda: train_profile.run(**PROFILE_DEPTH),
        "train_profile float32": lambda: train_profile.run(
            dtype="float32", **PROFILE_DEPTH),
        "head_profile": lambda: head_profile.run(**PROFILE_DEPTH),
        "bench_align_variants": lambda: bench_align_variants.run(
            **PROFILE_DEPTH),
    }
    for name, tool in tools.items():
        t1 = time.perf_counter()
        try:
            rows = tool()
            _profile_common.check_rows(rows)
        except Exception as e:  # every tool runs; the phase fails after
            fails.append(f"(b) {name}: {type(e).__name__}: {e}")
            continue
        numbers[name] = {
            "seconds": time.perf_counter() - t1,
            "rows": {r["name"]: {k: r[k] for k in (
                "device_ms", "events_ms", "flops", "bytes")}
                for r in rows}}
        print(f"phase 11 (b) {name}: {len(rows)} rows, "
              f"{numbers[name]['seconds']:.1f} s")
    counts = {k: wrappers[k].launches for k in PROFILED_KERNELS}
    print(f"phase 11 (b), the profiling tools: "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        require_launched(counts, "profiling tools (phase 11 (b))")
    except AssertionError as e:
        fails.append(f"(b) {e}")

    # (c) check_eval_memory, each in a fresh process (its own peak RSS)
    for argv in (["--images", "200", "--raw"], ["--images", "50"]):
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m",
             "mask_rcnn_tpu_torch.examples.check_eval_memory", *argv],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        out = res.stdout.strip()
        print(f"phase 11 (c) check_eval_memory {' '.join(argv)} (exit "
              f"{res.returncode}, {time.perf_counter() - t1:.1f} s):\n"
              f"{out}\n{res.stderr[-2000:]}")
        numbers["check_eval_memory " + " ".join(argv)] = out.splitlines()
        if res.returncode != 0 or "RSS BOUNDED: OK" not in out:
            fails.append(f"(c) check_eval_memory {' '.join(argv)}")

    # (d) check_dtype_parity's plumbing on the card, its rehearsals and
    # their drivers in this process
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dtype_parity_") as tmp:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), unittest.mock.patch.object(
                    subprocess, "run",
                    run_module_in_process(subprocess.run)):
                result = check_dtype_parity.main([
                    "--min-size", "64", "--max-size", "96", "--max-epoch",
                    "2", "--n-val", "4", "--min-map", "-1", "--workdir",
                    tmp, "--device", "cuda"])
        except BaseException as e:  # SystemExit from a failed rehearsal
            print(buf.getvalue()[-6000:])
            fails.append(f"(d) check_dtype_parity: {type(e).__name__}: {e}")
            result = None
    if result is not None:
        numbers["check_dtype_parity"] = result
        print(f"phase 11 (d) check_dtype_parity (tiny, on the card, "
              f"{time.perf_counter() - t1:.1f} s): {json.dumps(result)}")
        if not all(np.isfinite(result[k][m]) for k in ("f32", "bf16")
                   for m in ("map@0.5", "map")):
            fails.append(f"(d) check_dtype_parity: {result}")
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {numbers['seconds']:.1f} s")
    assert not fails, "phase 11 failed:\n" + "\n".join(fails)
    return counts, numbers


# Phase 12 must launch these: K10, K1, K2, K3, K7, K9a, K9b.
BENCH_KERNELS = ("stem_forward", "roi_align_grouped", "nms_blocked",
                 "decode_select", "roi_align_grouped_backward",
                 "anchor_targets", "proposal_targets")


def drive_bench(torch):
    """Phase 12: ``mask_rcnn_tpu_torch.bench.main([])``, the port's
    headline benchmark at its defaults, in this process. Prints its JSON
    line and its dispatch-included rate beside the card's name and power
    limit, and fails unless every number is finite and above 0, ``0 < mfu
    < 1.05``, the train step ran at batch 2 in bf16 at 832x1344 and
    :data:`BENCH_KERNELS` were launched. Returns the launch counts and the
    numbers."""
    import contextlib
    import io

    from mask_rcnn_tpu_torch import bench
    from mask_rcnn_tpu_torch.examples import _profile_common

    wrappers = _profile_common.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = bench.main([])
    finally:
        print(f"phase 12, bench stderr:\n{err.getvalue()[-4000:]}")
    seconds = time.perf_counter() - t0
    counts = {k: wrappers[k].launches for k in BENCH_KERNELS}
    lines = out.getvalue().strip().splitlines()
    assert code == 0 and lines, (code, out.getvalue()[-4000:])
    result = json.loads(lines[-1])
    print(f"phase 12, bench ({seconds:.1f} s) on {nvidia_smi()}: "
          f"{json.dumps(result)}")
    train = result["train"]
    numbers = [result["value"], result["vs_baseline"], train["step_ms"],
               train["images_per_sec"], train["mfu"]]
    assert all(isinstance(x, (int, float)) and np.isfinite(x) and x > 0
               for x in numbers), f"bench numbers: {numbers}"
    assert 0 < train["mfu"] < 1.05, f"bench mfu {train['mfu']}"
    assert (train["batch"], train["dtype"], train["image_hw"]) == (
        2, "bfloat16", [832, 1344]), train
    require_launched(counts, "bench (phase 12)")
    return counts, {"result": result, "stderr": err.getvalue().strip(),
                    "seconds": seconds}


# ---- Phase 9: data parallelism on the card --------------------------------

DP_STEPS = 3  # full-width steps of the two-rank runs and their references
DP_TIMEOUT_S = 600  # every rank's collectives, and the launcher's wait
# Step 1's limits, (losses relative, each leaf's update against its largest
# update). float32: phase 3's 2e-3 for the train step on the card. bf16: a
# leaf's gradient is a bf16 value, whose one rounding is 2^-8 = 3.9e-3 of
# it, and K7's float atomics move it by a rounding from run to run, so the
# same code misses 2e-3; the smoke reads repeated plain bf16 steps against
# each other beside the two ranks, and holds a control (each rank dividing
# by its own counts, the gradients averaged) to missing these limits.
DP_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (5e-3, 2e-2)}
DP_DTYPES = ("float32", "bfloat16")
DP_PLAIN_REPEATS = 2  # more plain bf16 steps 1, read against the reference


def dp_kernel_wrappers():
    """The train path's kernels (K10, K1, K2, K3, K7, K9a, K9b) by the
    wrappers that count their launches."""
    from mask_rcnn_tpu_torch.models import resnet
    from mask_rcnn_tpu_torch.ops import nms, roi_align, targets

    return (resnet.stem_forward, roi_align.roi_align_grouped,
            nms.nms_blocked, nms.decode_select,
            roi_align.roi_align_grouped_backward, targets.anchor_targets,
            targets.proposal_targets)


def step_counts(counts):
    """The train step's kernels among ``counts`` (K3 serves evaluation)."""
    return {k: c for k, c in counts.items() if k != "decode_select"}


def dp_config(dtype="bfloat16"):
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig

    return MaskRCNNConfig(n_fg_class=N_CLASS_FG, min_size=800,
                          max_size=1333, anchor_scales=(2, 4, 8, 16, 32),
                          compute_dtype=dtype)


def dp_batch(torch, dev):
    """Phase 9's b2 batch: phase 2's, but image 1 keeps only its first gt
    box. Each image of phase 2's batch fills the 128 positive rois of its
    512, so every loss count is equal across the images and per-rank
    denominators would give the global ones; here image 1 has fewer
    positives, hence fewer mask cells, so they differ."""
    batch = train_batch(torch, 2, *TRAIN_HW, dev)
    batch["bbox_valid"][1, 1:] = False
    return batch


def dp_steps(torch, batch, dtype, wrap=None, n_steps=DP_STEPS):
    """``n_steps`` full-width align steps (R-50-C4 COCO, ``dtype`` compute,
    float32 masters, seeded params, each step's priorities from ``(SEED,
    step)``) on ``batch``; ``wrap`` turns the step into a rank's. Returns
    the metrics of each step, the trainable leaves after the first step and
    after the last (on the CPU) and each step's synchronised host
    seconds."""
    from mask_rcnn_tpu_torch import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params
    from mask_rcnn_tpu_torch.parallel.mesh import barrier, broadcast_params
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    cfg = dp_config(dtype)
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         batch["image"].device)
    opt, _ = make_optimizer(params, 0.02, 1000)
    state = create_train_state(params, opt)
    broadcast_params(state.params)  # nothing to do in one process
    step = make_train_step(cfg, opt)
    if wrap is not None:
        step = wrap(step)
    flat = flatten_params(state.params)
    metrics, seconds, leaves = [], [], []
    for i in range(n_steps):
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, SEED)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: v.item() for k, v in m.items()})
        if i in (0, n_steps - 1):
            # copies: the next step updates the params in place
            leaves.append({k: flat[k].detach().to("cpu", copy=True)
                           for k in opt.trainable})
    return metrics, leaves[0], leaves[-1], seconds


def dp_compare(what, got, want, p_init, tol):
    """``got``'s (metrics, leaves after step 1, leaves after the last
    step) against ``want``'s: step 1's losses relative and the first
    step's update of each trainable leaf (the step's gradient) against its
    largest, held to ``tol`` = (losses, updates); where ``got`` ran more
    steps, the later steps' losses and the last leaves (against their
    largest update since ``p_init``) as readings: the runs' paths part
    once their params differ. Returns the worst of each and the failures
    against ``tol``."""
    (gm, g1, gn), (wm, w1, wn) = got, want
    rel = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w)
           for g, w in zip(gm, wm)]
    out = {"loss_rel_err_step1": rel[0]}
    fails = []
    if rel[0] > tol[0]:
        fails.append(f"{what}: step 1's losses differ by {rel[0]:.3e}")
    later = [("last", gn, wn)] if len(gm) > 1 else []
    for name, got_p, want_p in [("step1", g1, w1)] + later:
        worst = 0.0
        for k, w in want_p.items():
            upd = (w - p_init[k]).abs().max().item()
            ulp = 4 * float(np.finfo(np.float32).eps) * w.abs().max().item()
            err = (got_p[k] - w).abs().max().item()
            worst = max(worst, max(err - ulp, 0.0) / max(upd, 1e-30))
            if name == "step1" and err > tol[1] * upd + ulp:
                fails.append(f"{what}: {k} after step 1 differs by "
                             f"{err:.3e} (its step's largest update "
                             f"{upd:.3e})")
        out[f"param_rel_err_{name}"] = worst
    line = (f"{what}: step 1 losses worst rel err {rel[0]:.3e}, "
            f"{len(w1)} trainable leaves' step-1 update worst max|err| / "
            f"max|update| {out['param_rel_err_step1']:.3e} (limits "
            f"{tol[0]:g} / {tol[1]:g})")
    if later:
        out["loss_rel_err_later"] = max(rel[1:])
        line += (f"; later steps (paths part): losses "
                 f"{out['loss_rel_err_later']:.3e}, leaves after step "
                 f"{len(gm)} {out['param_rel_err_last']:.3e}")
    print(line)
    return out, fails


def dp_records_differ(pooled, one, order):
    """Where the pooled evaluation's match records (``get_state()``, its
    images in ``order``) differ from one process's; empty when equal."""
    if pooled["class_ids"] != one["class_ids"]:
        return [f"class ids {sorted(pooled['class_ids'])} vs "
                f"{sorted(one['class_ids'])}"]
    if len(pooled["per_image"]) != len(one["per_image"]):
        return [f"{len(pooled['per_image'])} images pooled vs "
                f"{len(one['per_image'])}"]
    out = []
    for j, i in enumerate(order):
        got, want = pooled["per_image"][j], one["per_image"][i]
        if got.keys() != want.keys():
            out.append(f"image {i}: classes {sorted(got)} vs {sorted(want)}")
            continue
        out += [f"image {i}, class {c}: {f} differs" for c in want
                for f in want[c]
                if not np.array_equal(got[c][f], want[c][f])]
    return out


def dp_evaluator(val_ds, pool):
    """A COCO evaluator of ``val_ds`` that scores every detection (score
    threshold 0, so random weights give records to compare) and keeps the
    match records it scores in ``records`` (the pooled ones, where it
    pools)."""
    from mask_rcnn_tpu_torch.engine import evaluator as evm

    records = []

    class Recording(evm.COCOEvaluation):
        def results(self):
            records.append(self.get_state())
            return super().results()

    class Evaluator(evm.InstanceSegmentationEvaluator):
        def __call__(self, model):
            model.score_thresh = 0.0
            saved, evm.COCOEvaluation = evm.COCOEvaluation, Recording
            try:
                return super().__call__(model)
            finally:
                evm.COCOEvaluation = saved

    ev = Evaluator(val_ds, val_ds.class_names, kind="coco", batch_size=2,
                   pool_detections=pool)
    ev.records = records
    return ev


def dp_rank(mode, out):
    """One rank of phase 9, started by ``drive_data_parallel`` through
    ``parallel/dryrun.py::launch``; writes ``{mode}_rank{r}.json`` (and,
    rank 0 of ``gloo2``, its params) into ``out``.

    ``nccl1``: NCCL, world size 1, the float32 data-parallel step against
    the plain one on the b2 batch. ``gloo2``: two gloo ranks sharing
    ``cuda:0``, each its row of the b2 batch for ``DP_STEPS`` float32 and
    ``DP_STEPS`` bf16 steps, a bf16 step 1 of the control (each rank
    divides its losses by its own counts and the gradients are averaged, a
    plain DDP port), the all-reduce timed alone, then ``train()`` over
    phase 7's images."""
    import torch
    import torch.distributed as dist

    from mask_rcnn_tpu_torch.parallel.mesh import (
        DataParallel,
        all_reduce_grads,
        barrier,
        destroy_distributed,
        init_distributed,
        local_batch_slice,
        make_parallel_train_step,
        process_count,
        process_index,
    )

    dev = init_distributed("nccl" if mode == "nccl1" else "gloo", "cuda:0",
                           timeout=DP_TIMEOUT_S)
    try:
        rank = process_index()
        kernels = dp_kernel_wrappers()
        full = dp_batch(torch, dev)
        res = {"rank": rank, "world": process_count()}

        def counted(fn):
            for w in kernels:
                w.launches = 0
            out_ = fn()
            torch.cuda.synchronize()
            return out_, {w.__name__: w.launches for w in kernels}

        if mode == "nccl1":
            got, res["launches"] = counted(lambda: dp_steps(
                torch, full, "float32", make_parallel_train_step))
            plain = dp_steps(torch, full, "float32")
            res["compare"], res["fails"] = dp_compare(
                "float32, NCCL world size 1 vs the plain step", got[:3],
                plain[:3], dp_initial_params(torch), DP_TOL["float32"])
            res["seconds"], res["plain_seconds"] = got[3], plain[3]
        else:
            local = {k: v[local_batch_slice(2)] for k, v in full.items()}
            del full
            saved, digests = {}, {}
            for dtype in DP_DTYPES:
                (m, p1, p, s), counts = counted(lambda: dp_steps(
                    torch, local, dtype, make_parallel_train_step))
                res[dtype] = {"metrics": m, "seconds": s}
                if dtype == "bfloat16":  # the main path's
                    res["launches"] = counts
                saved[dtype] = (p1, p)
                digests[dtype] = [float(p[k].double().sum())
                                  for k in sorted(p)]

            class PerRankLosses(DataParallel):
                """The control. A step's first all-reduce is its losses'
                counts: each rank keeps its own, times the world size, so
                the SUM of the ranks' gradients and metrics is the mean of
                their own normalized losses'."""
                calls = 0

                def all_reduce(self, t):
                    self.calls += 1
                    if self.calls % 2:
                        return t * self.world_size
                    return super().all_reduce(t)

            control = PerRankLosses.current()
            m, p1, _, _ = dp_steps(
                torch, local, "bfloat16", n_steps=1,
                wrap=lambda step: lambda *a: step(*a, data_parallel=control))
            res["control"] = {"metrics": m}
            saved["control"] = (p1, p1)
            gathered = [None] * process_count()
            dist.all_gather_object(gathered, digests)
            res["params_identical"] = all(d == gathered[0] for d in gathered)
            if rank == 0:
                torch.save(saved, os.path.join(out, "dp_params.pt"))
            # the all-reduce alone, on buffers shaped like the gradients
            grads = [v.to(dev) for v in saved["bfloat16"][1].values()]
            del saved
            ar = []
            for _ in range(4):
                barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_grads(grads)
                torch.cuda.synchronize()
                ar.append(time.perf_counter() - t0)
            res["all_reduce_seconds"] = ar[1:]
            res["grad_bytes"] = sum(g.numel() * g.element_size()
                                    for g in grads)
            del grads, local
            res["loop"], res["loop_launches"] = counted(
                lambda: dp_train_loop(torch, dev, out))
        with open(os.path.join(out, f"{mode}_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        destroy_distributed()


def dp_initial_params(torch):
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    return flatten_params(init_params(dp_config(),
                                      torch.Generator().manual_seed(SEED)))


def dp_loop_data():
    rng = np.random.RandomState(SEED + 7)
    return (rectangles_dataset(rng, 16, *LOOP_HW),
            rectangles_dataset(rng, 4, *LOOP_HW))


def dp_train_loop(torch, dev, out):
    """``train()`` as one of two ranks over phase 7's images (1 a rank,
    global batch 2): run A stops at step 2 with a checkpoint, run B
    resumes from it to step 4 and evaluates (pooled) at step 4."""
    import pickle

    from mask_rcnn_tpu_torch.data import MaskRCNNTransform, TrainLoader
    from mask_rcnn_tpu_torch.engine.loop import train
    from mask_rcnn_tpu_torch.parallel.mesh import (
        process_count,
        process_index,
    )

    train_ds, val_ds = dp_loop_data()
    lo, hi = LOOP_SIZES
    cfg = dp_config()
    evaluator = dp_evaluator(val_ds, pool=True)

    def loader():
        return TrainLoader(train_ds, MaskRCNNTransform(
            lo, hi, cfg.mean, train=True, rng=np.random.RandomState(SEED)),
            batch_size=1, max_boxes=8, min_size=lo, max_size=hi, seed=SEED,
            process_index=process_index(), process_count=process_count())

    kw = dict(max_epoch=1.0, evaluator=evaluator, eval_interval_epochs=0.5,
              log_interval=2, checkpoint_interval_steps=2, seed=SEED,
              device=dev)
    run_a, run_b = os.path.join(out, "loop_a"), os.path.join(out, "loop_b")
    t0 = time.perf_counter()
    res_a = train(cfg, loader(), run_a, stop_at_step=2, **kw)
    res_b = train(cfg, loader(), run_b, stop_at_step=4,
                  resume_from=os.path.join(run_a, "train_state"), **kw)
    if process_index() == 0:
        with open(os.path.join(out, "pooled_records.pkl"), "wb") as f:
            pickle.dump(evaluator.records, f)
    return {"iterations": [res_a["iterations"], res_b["iterations"]],
            "seconds": time.perf_counter() - t0}


def drive_data_parallel(torch, kernels):
    """Phase 9: the data-parallel path on the card, in ranks that
    ``parallel/dryrun.py::launch`` starts (this process holds no group):
    (i) NCCL at world size 1, the data-parallel step against the plain
    one; (ii) two gloo ranks sharing ``cuda:0`` at full width, batch 1
    each, against this process's b2 step on the same priorities (float32
    and bf16, each at its ``DP_TOL``; repeated plain bf16 steps read
    against each other; the control must miss the bf16 limits), with the
    launch counters of the path's kernels moving in every rank; (iii)
    ``train()`` on the two ranks, 4 steps, a resume and a pooled
    evaluation whose match records and report equal a one-process
    evaluation's. Returns the launch counts summed over the ranks (all
    runs; the default configuration's: the bf16 steps and ``train()``)
    and the phase's numbers."""
    import pickle
    import tempfile

    from mask_rcnn_tpu_torch import MaskRCNNResNet
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params
    from mask_rcnn_tpu_torch.parallel.dryrun import launch
    from mask_rcnn_tpu_torch.utils.checkpoint import load_params

    dev = torch.device("cuda")
    full = dp_batch(torch, dev)
    ref = {dtype: dp_steps(torch, full, dtype) for dtype in DP_DTYPES}
    repeats = [dp_steps(torch, full, "bfloat16", n_steps=1)
               for _ in range(DP_PLAIN_REPEATS)]
    del full
    torch.cuda.empty_cache()
    p0 = dp_initial_params(torch)
    out, fails = {}, []
    out["plain_bf16_repeats"] = []
    runs = [ref["bfloat16"]] + repeats
    for j in range(1, len(runs)):
        for i in range(j):
            cmp, bad = dp_compare(
                f"bfloat16, plain b2 step 1, run {j + 1} vs run {i + 1}",
                runs[j][:3], runs[i][:3], p0, DP_TOL["bfloat16"])
            out["plain_bf16_repeats"].append(cmp)
            fails += bad
    del repeats, runs
    counts = {w.__name__: 0 for w in kernels}
    counts_main = dict(counts)
    with tempfile.TemporaryDirectory(prefix="mrcnn_dp_") as tmp:
        for mode, nproc in (("nccl1", 1), ("gloo2", 2)):
            cmd = [sys.executable, os.path.abspath(__file__), "--dp-rank",
                   mode, tmp]
            t0 = time.perf_counter()
            try:
                launch(cmd, nproc, DP_TIMEOUT_S, log_dir=tmp)
            finally:
                for r in range(nproc):
                    for ext in ("out", "err"):
                        path = os.path.join(tmp, f"rank{r}.{ext}")
                        with open(path) as f:
                            text = f.read().strip()
                        if text:
                            print(f"[{mode} rank {r} {ext}]\n" + "\n".join(
                                text.splitlines()[-40:]))
            out[f"{mode}_wall_s"] = time.perf_counter() - t0
            ranks = []
            for r in range(nproc):
                with open(os.path.join(tmp, f"{mode}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            for r, res in enumerate(ranks):
                require_launched(step_counts(res["launches"]),
                                 f"data-parallel step ({mode}, rank {r})")
                for k, c in res["launches"].items():
                    counts[k] += c
                    if mode == "gloo2":  # bf16; nccl1's steps are float32
                        counts_main[k] += c
            if mode == "nccl1":
                out["nccl1"] = dict(ranks[0]["compare"],
                                    seconds=ranks[0]["seconds"],
                                    plain_seconds=ranks[0]["plain_seconds"])
                print("NCCL world size 1:", out["nccl1"])
                fails += ranks[0]["fails"]
                continue
            if not all(r["params_identical"] for r in ranks):
                fails.append("the two ranks' params differ")
            params = torch.load(os.path.join(tmp, "dp_params.pt"))
            cmp = {}
            for dtype in DP_DTYPES:
                got = (ranks[0][dtype]["metrics"], *params[dtype])
                cmp[dtype], bad = dp_compare(
                    f"{dtype}, two gloo ranks (b1 each) vs one process "
                    "(b2)", got, ref[dtype][:3], p0, DP_TOL[dtype])
                fails += bad
            got = (ranks[0]["control"]["metrics"], *params["control"])
            cmp["control"], bad = dp_compare(
                "control: bfloat16, two gloo ranks each dividing by its own "
                "counts, gradients averaged, vs one process (b2)", got,
                ref["bfloat16"][:3], p0, DP_TOL["bfloat16"])
            if not bad:
                fails.append("the control met the bf16 limits: they cannot "
                             "tell the global denominators from per-rank "
                             "ones")
            print(f"control missed the bf16 limits in {len(bad)} place(s), "
                  "as it must" if bad else "control met the bf16 limits")
            del params
            step_s = [max(r["bfloat16"]["seconds"][i] for r in ranks)
                      for i in range(DP_STEPS)]
            ar_s = [max(r["all_reduce_seconds"][i] for r in ranks)
                    for i in range(len(ranks[0]["all_reduce_seconds"]))]
            ms_2 = 1e3 * float(np.median(step_s[1:]))
            ms_1 = 1e3 * float(np.median(ref["bfloat16"][3][1:]))
            ar_ms = 1e3 * float(np.median(ar_s))
            print(f"data-parallel step, R-50-C4 COCO 832x1344 bf16: two "
                  f"gloo ranks sharing one card, b1 each: {ms_2:.3f} ms/step; "
                  f"one process b2: {ms_1:.3f} ms/step (host clock, "
                  f"synchronised, median of steps 2-{DP_STEPS}); "
                  f"difference {ms_2 - ms_1:.3f} ms = "
                  f"{(ms_2 - ms_1) / ms_2:.1%} of the two-rank step; the "
                  f"gradient all-reduce alone ({ranks[0]['grad_bytes']} "
                  f"bytes, gloo through the host) {ar_ms:.3f} ms = "
                  f"{ar_ms / ms_2:.1%}. Two ranks on one card: the "
                  "collective's cost, not scaling")
            for dtype in DP_DTYPES:
                for i, (g, w) in enumerate(zip(ranks[0][dtype]["metrics"],
                                               ref[dtype][0])):
                    print(f"  {dtype} step {i + 1} loss: two ranks "
                          f"{g['loss']:.6f}, one process {w['loss']:.6f}")
            out["gloo2"] = dict(compare=cmp, ms_per_step_2ranks=ms_2,
                                ms_per_step_1proc_b2=ms_1,
                                all_reduce_ms=ar_ms,
                                grad_bytes=ranks[0]["grad_bytes"],
                                step_seconds=step_s,
                                ref_step_seconds=ref["bfloat16"][3],
                                f32_step_seconds=[
                                    max(r["float32"]["seconds"][i]
                                        for r in ranks)
                                    for i in range(DP_STEPS)],
                                f32_ref_step_seconds=ref["float32"][3])

            # (iii) train() on two ranks: the loop's kernels in every rank,
            # rank 0's artifacts, and the pooled records and report against
            # this process's evaluation of the same params
            for r, res in enumerate(ranks):
                require_launched(res["loop_launches"],
                                 f"data-parallel train() (rank {r})")
                for k, c in res["loop_launches"].items():
                    counts[k] += c
                    counts_main[k] += c
                assert res["loop"]["iterations"] == [2, 4], res["loop"]
            run_b = os.path.join(tmp, "loop_b")
            with open(os.path.join(run_b, "params.yaml")) as f:
                pyaml = json.load(f)
            assert (pyaml["n_devices"], pyaml["batch_size"]) == (2, 2), pyaml
            assert abs(pyaml["lr"] - 0.0025) < 1e-12, pyaml
            log = read_log(run_b)
            reports = [e for e in log if "validation/main/map" in e]
            losses = [e for e in log if "main/loss" in e]
            assert [e["iteration"] for e in reports] == [4], log
            assert all(np.isfinite(v) for e in losses for k, v in e.items()
                       if k.startswith("main/")), losses
            cfg = dp_config()
            snapshot = load_params(os.path.join(run_b, "snapshot_model.npz"),
                                   dev, like=init_params(
                                       cfg, torch.Generator().manual_seed(0),
                                       dev))
            _, val_ds = dp_loop_data()
            evaluator = dp_evaluator(val_ds, pool=False)
            one = evaluator(MaskRCNNResNet.from_config(cfg, snapshot,
                                                       device=dev))
            with open(os.path.join(tmp, "pooled_records.pkl"), "rb") as f:
                pooled_records = pickle.load(f)
            n = len(val_ds)
            order = [i for r in range(2) for i in range(n)[r::2]]
            differ = dp_records_differ(pooled_records[-1],
                                       evaluator.records[-1], order)
            n_dets = sum(len(rec["det_scores"])
                         for img in evaluator.records[-1]["per_image"]
                         for rec in img.values())
            assert not differ, differ[:10]
            pooled = {k: v for k, v in reports[0].items()
                      if k.startswith("validation/")}
            # NaN: a class with detections and no ground truth
            assert pooled.keys() == one.keys() and all(
                pooled[k] == v or (np.isnan(pooled[k]) and np.isnan(v))
                for k, v in one.items()), (pooled, one)
            print(f"data-parallel train(): 2 ranks, steps 1-2, checkpoint, "
                  f"resume to 4, pooled COCO evaluation at step 4 (score "
                  f"threshold 0): the match records of its {n} images "
                  f"({n_dets} detections) and its report equal one "
                  f"process's ({len(one)} keys, map "
                  f"{one.get('validation/main/map')}, map@0.5 "
                  f"{one.get('validation/main/map@0.5')}); "
                  f"{ranks[0]['loop']['seconds']:.2f} s wall in rank 0")
            out["loop"] = {"seconds": ranks[0]["loop"]["seconds"],
                           "map": one.get("validation/main/map"),
                           "detections": n_dets}
    print(f"kernel launches during the data-parallel runs (all ranks): "
          f"{counts}; of the default configuration (bf16 steps, train()): "
          f"{counts_main}")
    assert not fails, "phase 9 failed:\n" + "\n".join(fails)
    return counts, counts_main, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="OTHER_CHECKOUT",
                    help="time K1, K2, K4, K7, K13, K10, the target "
                    "creators, decode, K12, K6, K11, K5, the align predict "
                    "step and the align train step against another "
                    "checkout's instead of the smoke")
    ap.add_argument("--ab-worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", nargs=2, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.ab_worker:
        ab_worker(*a.ab_worker)
        return 0
    if a.dp_rank:
        dp_rank(*a.dp_rank)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if a.against:
        return run_against(torch, a.against)
    from mask_rcnn_tpu_torch.models import resnet
    from mask_rcnn_tpu_torch.models.mask_rcnn import set_float32_precision
    from mask_rcnn_tpu_torch.ops import _kernels, nms, roi_align, targets

    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    set_float32_precision()
    print("tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    results = {}
    check_kernels(torch, results)
    check_decode_kernel(torch, results)
    check_train_kernels(torch, results)
    check_pool_kernels(torch, results)
    check_stem_kernel(torch, results)
    check_flat_kernels(torch, results)
    for pooling in POOLERS:
        check_small_reference(torch, pooling)
        check_train_reference(torch, pooling)

    # Each main path runs with its kernels' counts set to 0 just before it
    # and read just after; a kernel's "launches" sums its main-path runs,
    # "launches_main" those of the default configuration (pooling="align"):
    # the align serving and train runs, the driver, the entry points, the
    # data-parallel bf16 steps and train(), and the last mile.
    pool_fwd = {"align": roi_align.roi_align_grouped,
                "resize": roi_align.crop_and_resize,
                "pooling": roi_align.roi_pool}
    pool_bwd = {"align": roi_align.roi_align_grouped_backward,
                "resize": roi_align.crop_and_resize_backward,
                "pooling": roi_align.roi_pool_backward}
    launches, launches_main, serving, training = {}, {}, {}, {}

    def count(counts, main):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
            if main:
                launches_main[name] = launches_main.get(name, 0) + c

    for pooling in POOLERS:
        counts, ms_img, step_ms = drive_main_path(
            torch, (resnet.stem_forward, pool_fwd[pooling], nms.nms_blocked,
                    nms.decode_select), pooling)
        count(counts, pooling == "align")
        serving[pooling] = {"predict_ms_per_img_b1": ms_img,
                            "predict_submit_ms_per_img_b1": step_ms}
    for pooling in POOLERS:
        counts, ms, host_ms, peak_gb, extra = drive_train_path(
            torch, (resnet.stem_forward, pool_fwd[pooling], nms.nms_blocked,
                    pool_bwd[pooling], targets.anchor_targets,
                    targets.proposal_targets),
            pooling, reps=10 if pooling == "align" else 5)
        count(counts, pooling == "align")
        training[pooling] = {"train_ms_per_step_b2": ms,
                             "train_img_per_s_b2": 2e3 / ms,
                             "train_host_ms_per_step_b2": host_ms,
                             "train_peak_gib": peak_gb, "launches": counts}
        training[pooling].update(extra)
        if "k2_on_step" in extra:
            results["nms_blocked"]["step_ms"] = extra["k2_on_step"]["ms"]
            results["nms_blocked"]["step_plain_ms"] = \
                extra["k2_on_step"]["plain_ms"]
    counts, flat_ms = drive_flat_head(
        torch, (roi_align.roi_align, roi_align.roi_align_backward))
    count(counts, False)
    counts, loop = drive_train_loop(
        torch, (resnet.stem_forward, roi_align.roi_align_grouped,
                nms.nms_blocked, nms.decode_select,
                roi_align.roi_align_grouped_backward,
                targets.anchor_targets, targets.proposal_targets))
    count(counts, True)
    loop["launches"] = counts
    counts, entry_points = drive_entry_points(
        torch, (resnet.stem_forward, roi_align.roi_align_grouped,
                nms.nms_blocked, nms.decode_select,
                roi_align.roi_align_grouped_backward,
                targets.anchor_targets, targets.proposal_targets))
    count(counts, True)
    entry_points["launches"] = counts
    counts, counts_main, data_parallel = drive_data_parallel(
        torch, dp_kernel_wrappers())
    count(counts, False)
    for name, c in counts_main.items():
        launches_main[name] = launches_main.get(name, 0) + c
    data_parallel["launches"] = counts
    serve_counts, train_counts, last_mile = drive_last_mile(
        torch, (resnet.stem_forward, roi_align.roi_align_grouped,
                nms.nms_blocked, nms.decode_select),
        (resnet.stem_forward, roi_align.roi_align_grouped, nms.nms_blocked,
         nms.decode_select, roi_align.roi_align_grouped_backward,
         targets.anchor_targets, targets.proposal_targets))
    count(serve_counts, True)
    count(train_counts, True)
    last_mile["launches"] = {"serve": serve_counts, "train": train_counts}
    counts, profiled = drive_profiling(
        torch, training["align"],
        {k: results[k]["ms"] for k in ("roi_align_grouped", "nms_blocked")})
    count(counts, False)
    profiled["launches"] = counts
    counts, benched = drive_bench(torch)
    count(counts, False)
    benched["launches"] = counts
    for name, entry in results.items():
        # nms_small serves no main path since decode_select took the decode
        entry["launches"] = launches.get(name, 0)
        entry["launches_main"] = launches_main.get(name, 0)

    print(json.dumps({"serving": serving, "training": training,
                      "flat_head_ms_fwd_bwd": flat_ms, "train_loop": loop,
                      "entry_points": entry_points,
                      "data_parallel": data_parallel,
                      "last_mile": last_mile, "profiling": profiled,
                      "bench": benched, "card": smi}))
    order = ("roi_align_grouped", "nms_blocked", "nms_small",
             "decode_select", "roi_align_grouped_backward", "anchor_targets",
             "proposal_targets", "crop_and_resize",
             "crop_and_resize_backward", "roi_pool",
             "roi_pool_backward", "stem_forward", "roi_align",
             "roi_align_backward")
    print(json.dumps({"kernels": [results[k] for k in order]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
