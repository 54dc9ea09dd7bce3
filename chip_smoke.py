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
   same features with 1000 and 100 flat rois to 14x14 bins, K6 also on
   features holding NaN and +-inf (a bin with a NaN or +inf pools to 0),
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
   launched.

Prints the card's name and power limit, each path's times, one JSON line
of kernel results (``launches`` over every main-path run above,
``launches_main`` over the default configuration's: the ``align`` serving
and train runs and the train loop), and as its last line
``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, when a phase fails or no CUDA device
is present.

With ``--against OTHER_CHECKOUT`` it runs none of the above: it times K1,
K2, K4, K7, K13, K10, the two target creators, ``decode`` at the serving
shape, K12, K6, K11, the align ``predict_step`` at batch 1 and the align
train step of this checkout against another checkout's on the same inputs
(see :func:`run_against`).
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


# The least time the card could take: bytes at
# the H100's 3.35 TB/s, operations at the published peak for their type
# (bf16 989 TFLOP/s on the tensor cores, float32 67 TFLOP/s on the CUDA
# cores), whichever is larger.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def nbytes(*tensors):
    """Bytes of the tensors: each input read once, each output written
    once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak="f32"):
    """The kernel line's bound keys; no single torch call computes any of
    these functions (torchvision is not installed), so library_ms is
    null."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def align_samples(rois, feat_hw, p=7, s=2, scale=1 / 16):
    """RoIAlign's bilinear samples for these rois: sum over rois of
    P*P*gy*gx with Detectron's adaptive grid (8 float ops per sample and
    channel: four taps, each a multiply-add)."""
    r = np.asarray(rois, np.float32).reshape(-1, 4) * np.float32(scale)
    full = p * s
    ext = np.maximum(r[:, 2:] - r[:, :2], 1.0)
    gy = np.clip(np.ceil(ext[:, 0] / full), 1, -(-feat_hw[0] // full))
    gx = np.clip(np.ceil(ext[:, 1] / full), 1, -(-feat_hw[1] // full))
    return float((gy * gx).sum()) * p * p


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


def nms_stops(idx, mask, n, max_out):
    """Per problem, the candidates that a greedy scan reads: up to the last
    kept box once ``max_out`` survive, else all ``n``."""
    stops = []
    for row_idx, row_mask in zip(idx.cpu().numpy(), mask.cpu().numpy()):
        kept = row_idx[row_mask]
        full = max_out and len(kept) >= max_out
        stops.append(int(kept.max()) + 1 if full else n)
    return stops


def nms_pairs(idx, mask, n, max_out):
    """IoU pairs a greedy NMS needs on this data: each kept box against the
    candidates after it, up to the row where the scan stopped (12 float ops
    a pair)."""
    pairs = 0
    for row_idx, row_mask, stop in zip(idx.cpu().numpy(), mask.cpu().numpy(),
                                       nms_stops(idx, mask, n, max_out)):
        kept = row_idx[row_mask]
        pairs += int((stop - kept - 1).clip(min=0).sum())
    return pairs


def scan_note(idx, mask, n, max_out):
    """Where K2's scan stopped, in candidates and tiles of 64."""
    stops = nms_stops(idx, mask, n, max_out)
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
    from mask_rcnn_tpu_torch.ops import nms, roi_align

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
        samples = align_samples(boxes, (52, 84))
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
            k1.update(bound(nbytes(feats, rois, got), 8 * 1024 * samples))
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
            **bound(nbytes(b, v, idx, mask),
                    12 * nms_pairs(idx, mask, b.shape[1], k)),
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
    from mask_rcnn_tpu_torch.ops import nms
    from mask_rcnn_tpu_torch.ops.tensors import gather_rows, top_k_stable

    n, rp, c = prob.shape
    fg_p = prob[:, :, 1:].transpose(1, 2).reshape(-1, rp)
    fg_b = cls_bbox[:, :, 1:].transpose(1, 2).reshape(-1, rp, 4)
    ok = valid[:, None, :].expand(n, c - 1, rp).reshape(-1, rp) & (
        fg_p > thresh)
    top_p, top_i = top_k_stable(torch.where(ok, fg_p, -torch.inf),
                                k if 0 < k < rp else rp)
    sel = torch.isfinite(top_p)
    plain = (nms.nms_small_plain if sel.shape[1] <= nms.SMALL_MAX_N
             else nms.nms_blocked_plain)
    idx, mask = plain(gather_rows(fg_b, top_i), sel, nms_thresh, d)
    pairs = 0
    for row_idx, row_mask, cnt in zip(idx.cpu().numpy(), mask.cpu().numpy(),
                                      sel.sum(1).tolist()):
        kept = row_idx[row_mask]
        stop = kept.max() + 1 if len(kept) >= d else cnt
        pairs += int((stop - kept - 1).clip(min=0).sum())
    n_bytes = (fg_p.numel() * 4 + valid.numel() + int(sel.sum()) * 16
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
    from mask_rcnn_tpu_torch.ops import targets

    bbox, valid, anchors, img_size = a_in
    _, label = targets.anchor_match_plain(
        anchors, bbox, valid, img_size, cfg.pos_iou_thresh,
        cfg.neg_iou_thresh)
    cand = (label >= 0).sum().item()
    return nbytes(bbox, valid, anchors, *got) + 4 * cand, {
        "candidate priorities": cand}


def proposal_target_bytes(torch, p_in, got, cfg):
    """The bytes K9b + K8's function must move on this run's data: the rois,
    gt boxes, labels and validity, one priority per sampling candidate, the
    outputs, and of the packed (N, G, H, W/8) masks only the distinct bytes
    that the positive crops' bilinear taps read. Returns (bytes, what was
    counted)."""
    from mask_rcnn_tpu_torch.ops import targets

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
    n_bytes = (nbytes(roi, roi_valid, *p_in[2:5], *got) + 4 * cand
               + mask_bytes)
    return n_bytes, {"candidate priorities": cand,
                     "crops": positive.sum().item(),
                     "distinct mask bytes": mask_bytes}


def check_train_kernels(torch, results):
    """Phase 2, training side: K7, K2 at the train counts, K9a and K9b + K8
    against their plain versions at the train step's shapes."""
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
        **bound(nbytes(g, rois, got),
                8 * 1024 * align_samples(rois.cpu().numpy(), (h // 16,
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
                           **bound(nbytes(x, params["conv1"]["W"], got),
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
                nbytes(feats, rois, idx, got),
                8 * 1024 * align_samples(rois.cpu().numpy(), (fh, fw))))
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
        **bound(nbytes(g, rois, idx, got),
                8 * 1024 * align_samples(rois.cpu().numpy(), (fh, fw)))}


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


def pool_reads(rois, p, scale=1 / 16, hw=(52, 84)):
    """Feature positions that max RoI pooling reads for these flat rois:
    the sum of its bins' areas (chainer's quantized bins)."""
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    r = rois.float()
    ys, ye = ra._pool_bounds(r[:, 0], r[:, 2], hw[0], p, scale)
    xs, xe = ra._pool_bounds(r[:, 1], r[:, 3], hw[1], p, scale)
    return float(((ye - ys)[:, :, None] * (xe - xs)[:, None, :]).sum())
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


TRAIN_ROIS = 512  # sampled rois per image at batch 2


def check_pool_kernels(torch, results):
    """Phase 2, the alternate poolers: K5 and K6 at the serving shapes
    ((1, 52, 84, 1024) bf16 C4 features, 1000 and 100 rois), K6 also on
    features that hold NaN, +inf and -inf (a bin with a NaN or +inf pools to
    0), K11 and K12 at the train shape ((2, 52, 84, 1024), 512 rois per
    image; K11 on a dense gradient and on the one res5's stride-2 convs
    send, zero on every odd py or odd px), each against its plain version;
    then K12 on rois inside a block of exact zeros, where every position of
    a bin ties."""
    from mask_rcnn_tpu_torch.ops import roi_align as ra

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 2)
    fh, fw = TRAIN_HW[0] // 16, TRAIN_HW[1] // 16
    zero_block = (slice(10, 20), slice(20, 40))

    def features(n):
        # relu'd values: half of them exact zeros, as on relu'd res4
        f = np.maximum(rng.randn(n, fh, fw, 1024), 0).astype(np.float32)
        f[(0, *zero_block)] = 0.0
        return torch.from_numpy(f).to(dev).bfloat16()

    def flat_rois(n, r):
        boxes = np.concatenate([proposal_like_boxes(rng, r, *TRAIN_HW)
                                for _ in range(n)])
        boxes[r - r // 20:r] = 0.0  # zero-padded slots, as proposals have
        idx = np.repeat(np.arange(n, dtype=np.int32), r)
        return torch.from_numpy(boxes).to(dev), torch.from_numpy(idx).to(dev)

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
        err = compare(f"K5 crop_and_resize {r} rois",
                      ra.crop_and_resize(feats, *args),
                      ra.crop_and_resize_plain(feats.float(), *args), 1e-5)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        ms = cuda_ms(torch, lambda: ra.crop_and_resize(feats, *args))
        plain_ms = cuda_ms(torch, lambda: ra.crop_and_resize_plain(
            feats.float(), *args), warmup=1, iters=2)
        print(f"K5 crop_and_resize {r} rois: kernel {ms:.4f} ms, plain f32 "
              f"{plain_ms:.4f} ms")

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
              f"{pool_reads(args[0], 14) * 2048 / 1e6:.1f} MB), "
              f"{nbytes(got) / 1e6:.1f} MB written")
        if r == SERVE_ROIS[0]:  # the box pass's; the mask pass's is printed
            k5["ms"], k5["plain_ms"] = ms, plain_ms
            k6["ms"], k6["plain_ms"] = k6_ms, k6_plain_ms
            io = nbytes(feats, args[0], args[1], got)
            # four bilinear taps per output value; a compare per value read
            k5.update(bound(io, 8 * got.numel()))
            k6.update(bound(io, 1024 * pool_reads(args[0], 14)))
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
         (g, feats, rois, idx), 2 * 1024 * pool_reads(rois, 14)),
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
                  f"{2 * 2 * 1024 * pool_reads(rois, 14) / 1e6:.1f} MB), "
                  f"at most {reads * 4 / 1e6:.1f} MB of atomics")
        else:
            atomics = crop_bwd_atomics(rois, idx, 14, n, 1024, s2)
            print(f"K11 logical bytes{' (stride 2)' if s2 else ''}: "
                  f"{nbytes(grad) / 1e6:.1f} MB of gradient reads, "
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
                             **bound(nbytes(*io, got), flops))

    # K12's tie rule: rois inside the zero block, where every position of a
    # bin ties; an integer gradient makes every weighted sum exact.
    y0, x0 = zero_block[0].start * 16, zero_block[1].start * 16
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
    profile_train(torch, step, state, batch)
    return counts, ms, host_ms, peak_gb, extra


def time_k2_on_step(torch, step, state, batch):
    """K2 on the train step's own proposals: one more step runs with the
    RPN's ``nms_padded`` recording the score-sorted boxes and valid flags
    that it hands to ``nms_blocked``; then K2 against its plain version on
    them (identical positions and masks), both timed, and where the scan
    stopped. The counts of the step's run were read before this."""
    from mask_rcnn_tpu_torch.models import rpn
    from mask_rcnn_tpu_torch.ops import nms

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
    stops = nms_stops(want_idx, want_mask, n, max_out)
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


class TimedEvaluator:
    """An evaluator that records its wall seconds per call (synchronised)."""

    def __init__(self, torch, evaluator):
        self.torch, self.evaluator, self.seconds = torch, evaluator, []

    def __call__(self, model):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = self.evaluator(model)
        self.torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return report


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

    ev = TimedEvaluator(torch, InstanceSegmentationEvaluator(
        val_ds, val_ds.class_names, kind="coco", batch_size=2))
    kw = dict(max_epoch=1.0, evaluator=ev, eval_interval_epochs=0.5,
              log_interval=4, checkpoint_interval_steps=4, seed=SEED,
              device=dev)
    assert loader().steps_per_epoch() == 8
    assert loader().position_for_step(4) == (0, 4)
    for wrapper in kernels:
        wrapper.launches = 0
    with tempfile.TemporaryDirectory(prefix="mrcnn_train_") as tmp:
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
    """Device time of two train steps by kernel family (profiler)."""
    box = [state]

    def run():
        box[0], _ = step(box[0], batch, SEED)

    events = device_events(torch, run, iters=2)
    print_families(families(events), "2 train steps (per step)")
    print("top kernels (ms per step, launches, name):")
    for name, cnt, ms in sorted(events, key=lambda e: -e[2])[:12]:
        print(f"  {ms:8.3f} {cnt:5g}  {name[:110]}")


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
            "k11_bf16_2x512_s2", "predict_b1", "align_step_b2")
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
    with the 1000 and 100 rois of K1)."""
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
    res5's stride-2 one (``k11_bf16_2x512``, ``k11_bf16_2x512_s2``),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="OTHER_CHECKOUT",
                    help="time K1, K2, K4, K7, K13, K10, the target "
                    "creators, decode, K12, K6, K11, the align predict step "
                    "and the align train step against another checkout's "
                    "instead of the smoke")
    ap.add_argument("--ab-worker", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.ab_worker:
        ab_worker(*a.ab_worker)
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
    # the align serving and train runs and the driver.
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
    for name, entry in results.items():
        # nms_small serves no main path since decode_select took the decode
        entry["launches"] = launches.get(name, 0)
        entry["launches_main"] = launches_main.get(name, 0)

    print(json.dumps({"serving": serving, "training": training,
                      "flat_head_ms_fwd_bwd": flat_ms, "train_loop": loop,
                      "card": smi}))
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
