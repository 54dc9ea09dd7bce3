#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mask_rcnn_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from ``mask_rcnn_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. holds each kernel against its plain torch version on the card at the
   main paths' shapes and times both with CUDA events: RoIAlign K1 on
   (1, 52, 84, 1024) bf16 features with 1000 and 100 rois; proposal NMS K2
   6000 -> 1000 at 0.7 and, at the train counts, (2, 12000) -> 2000;
   decode NMS K3 80 x 256 -> 100 at 0.5; RoIAlign
   backward K7 from (2, 512, 7, 7, 1024) bf16 to (2, 52, 84, 1024); the
   mask-target crop-resize K8 of (2, 8, 832, 168) packed masks to
   (2, 128, 14, 14); anchor matching K9 of 65520 anchors and proposal
   matching of (2, 2008) candidates to 8 gts per image; the alternate
   poolers' crop-and-resize K5 and max RoI pooling K6 (identical) on the
   same features with 1000 and 100 flat rois to 14x14 bins, and their
   backwards K11 and K12 from (1024, 14, 14, 1024) bf16 to
   (2, 52, 84, 1024), K12 also on rois inside a block of exact zeros
   (every position of a bin ties);
3. checks the whole predict step, and the whole train step (losses and
   gradients, with the same sampling priorities), on the GPU against the
   plain path on the CPU at small float32 inputs, under each RoI pooler
   (``pooling`` = ``align``, ``resize``, ``pooling``);
4. serving path, once per pooler: drives ``MaskRCNNResNet.predict`` at
   R-50-C4, COCO (80 classes), anchor scales (2, 4, 8, 16, 32), min 800 /
   max 1333 (buckets 832x1344 and 1344x832), bf16, seeded random weights:
   single images, a batch of two, and a request at ``score_thresh=0``;
   checks the outputs and that the pooler's forward kernel (K1, K5 or K6),
   K2 and K3 were launched during that run;
5. training path, once per pooler: ``make_train_step`` at the same
   configuration, bf16 compute with float32 master params, on a synthetic
   batch of 2 at the 832x1344 bucket with 8 gts per image and bit-packed
   masks: 3 warm-up and 10 (``align``) or 5 timed steps; checks that every
   loss is finite, that the frozen params did not change and every
   trainable one did, and that the pooler's kernels (K1/K7, K5/K11 or
   K6/K12), K2, K8 and K9 were launched during that run; then profiles two
   more steps.

Prints the card's name and power limit, each path's times, one JSON line
of kernel results, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, when a phase fails or no CUDA device
is present.
"""

import json
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
        print(f"K1 roi_align {r} rois: max|err| {err.max().item():.3e} "
              f"(rtol {rtol:g}, atol {atol:g}, {bad} outside), "
              f"kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms")
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{bad} values ({r} rois)")
        if r == 1000:  # the box pass's shape; the mask pass's is printed
            k1["ms"], k1["plain_ms"] = ms, plain_ms
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
        print(f"{'K2' if name == 'nms_blocked' else 'K3'} {name} "
              f"{tuple(b.shape)} -> {k}: identical={same} "
              f"(kept {int(mask.sum())}), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{n_diff} positions")
        results[name] = {
            "name": name, "route": "cuda",
            "source": "mask_rcnn_tpu_torch/csrc/nms.cu",
            "replaces": f"mask_rcnn_tpu/ops/nms.py:{line}",
            "max_abs_err": float(n_diff), "ms": ms, "plain_ms": plain_ms,
        }


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
    return counts, ms_img, step_ms


TRAIN_HW = (832, 1344)


def train_batch(torch, n, h, w, device, **kw):
    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch

    batch = make_synthetic_train_batch(n, h, w, np.random.RandomState(SEED),
                                       **kw)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def check_train_kernels(torch, results):
    """Phase 2, training side: K7, K8, K9 against their plain versions at
    the train step's shapes."""
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
    print(f"K7 roi_align backward {tuple(g.shape)} -> {tuple(got.shape)}: "
          f"max|err| {err.max().item():.3e} (rtol {rtol:g}, atol "
          f"{atol:.3e}, {bad} outside), contiguous NHWC "
          f"{got.is_contiguous()}, kernel {ms:.4f} ms, plain f32 "
          f"{plain_ms:.4f} ms")
    if bad or not got.is_contiguous():
        raise AssertionError(f"K7 disagrees with its plain version at {bad} "
                             "values")
    results["roi_align_grouped_backward"] = {
        "name": "roi_align_grouped_backward", "route": "cuda",
        "source": "mask_rcnn_tpu_torch/csrc/roi_align.cu",
        "replaces": "mask_rcnn_tpu/ops/roi_align.py:282",
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms}

    # K2 at the train counts: (2, 12000) score-sorted proposals -> 2000 at
    # 0.7, a (2, 12000, 188) int64 scratch; a tail of invalid rows.
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
          f"identical={n_diff == 0} (kept {mask.sum(1).tolist()}), scratch "
          f"({n}, {n_pre}, {-(-n_pre // 64)}) int64, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    if n_diff:
        raise AssertionError(f"K2 differs from its plain version at train "
                             f"counts at {n_diff} positions")
    k2 = results["nms_blocked"]
    k2["max_abs_err"] += float(n_diff)
    k2["train_ms"], k2["train_plain_ms"] = ms, plain_ms

    # K8: 128 positive slots per image, rois jittered around their gts.
    q = 128
    gt_index = torch.from_numpy(rng.randint(0, 8, (n, q))).to(dev)
    bbox = batch["bbox"].gather(1, gt_index[..., None].expand(n, q, 4))
    jitter = torch.from_numpy(rng.randn(n, q, 4).astype(np.float32) * 8)
    hi = torch.tensor([h, w, h, w], dtype=torch.float32, device=dev)
    crop_rois = torch.minimum((bbox + jitter.to(dev)).clamp(min=0), hi)
    fn = lambda: targets.mask_crop_resize(batch["mask"], gt_index,  # noqa
                                          crop_rois, 14, True)
    plain = lambda: targets.mask_crop_resize_plain(  # noqa
        batch["mask"], gt_index, crop_rois, 14, True)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    n_diff = (got != want).sum().item()
    ms, plain_ms = cuda_ms(torch, fn), cuda_ms(torch, plain)
    print(f"K8 mask crop-resize {tuple(batch['mask'].shape)} packed -> "
          f"{tuple(got.shape)}: identical={n_diff == 0} (ones "
          f"{int(got.sum())}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if n_diff:
        raise AssertionError(f"K8 differs from its plain version at {n_diff} "
                             "cells")
    results["mask_crop_resize"] = {
        "name": "mask_crop_resize", "route": "cuda",
        "source": "mask_rcnn_tpu_torch/csrc/targets.cu",
        "replaces": "mask_rcnn_tpu/models/targets.py:190",
        "max_abs_err": float(n_diff), "ms": ms, "plain_ms": plain_ms}

    # K9: 65520 anchors of the 52x84 grid, and 2000 proposals + 8 gts.
    cfg = MaskRCNNConfig(n_fg_class=N_CLASS_FG,
                         anchor_scales=(2, 4, 8, 16, 32))
    anchors = torch.from_numpy(make_anchors(cfg, h // 16, w // 16)).to(dev)
    cand = torch.cat([torch.from_numpy(np.stack(
        [proposal_like_boxes(rng, 2000, h, w) for _ in range(n)])).to(dev),
        batch["bbox"]], dim=1)
    cvalid = torch.from_numpy(rng.rand(n, 2008) > 0.02).to(dev)
    k9 = {"name": "anchor_match+proposal_match", "route": "cuda",
          "source": "mask_rcnn_tpu_torch/csrc/targets.cu",
          "replaces": "mask_rcnn_tpu/models/targets.py:54",
          "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name, fn, plain in (
        ("anchor_match",
         lambda: targets.anchor_match(anchors, batch["bbox"],
                                      batch["bbox_valid"], (h, w), 0.7, 0.3),
         lambda: targets.anchor_match_plain(anchors, batch["bbox"],
                                            batch["bbox_valid"], (h, w),
                                            0.7, 0.3)),
        ("proposal_match",
         lambda: targets.proposal_match(cand, cvalid, batch["bbox"],
                                        batch["bbox_valid"], 0.5, 0.5, 0.0),
         lambda: targets.proposal_match_plain(cand, cvalid, batch["bbox"],
                                              batch["bbox_valid"], 0.5, 0.5,
                                              0.0)),
    ):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        n_diff = sum((a != b).sum().item() for a, b in zip(got, want))
        ms, plain_ms = cuda_ms(torch, fn), cuda_ms(torch, plain)
        print(f"K9 {name} {tuple(got[0].shape)} x 8 gts: identical="
              f"{n_diff == 0}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if n_diff:
            raise AssertionError(f"K9 {name} differs from its plain version "
                                 f"at {n_diff} values")
        k9["max_abs_err"] += float(n_diff)
        k9["ms"] += ms
        k9["plain_ms"] += plain_ms
    results["anchor_match"] = k9


SERVE_ROIS = (1000, 100)  # the serving head passes' rois at batch 1
TRAIN_ROIS = 512  # sampled rois per image at batch 2


def check_pool_kernels(torch, results):
    """Phase 2, the alternate poolers: K5 and K6 at the serving shapes
    ((1, 52, 84, 1024) bf16 C4 features, 1000 and 100 rois), K11 and K12 at
    the train shape ((2, 52, 84, 1024), 512 rois per image), each against
    its plain version; then K12 on rois inside a block of exact zeros, where
    every position of a bin ties."""
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
        if r == SERVE_ROIS[0]:  # the box pass's; the mask pass's is printed
            k5["ms"], k5["plain_ms"] = ms, plain_ms
            k6["ms"], k6["plain_ms"] = k6_ms, k6_plain_ms
    results["crop_and_resize"], results["roi_pool"] = k5, k6

    # The backwards at the train shape: 2 images x 512 rois, 14x14 bins.
    n = 2
    feats = features(n)
    rois, idx = flat_rois(n, TRAIN_ROIS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn((n * TRAIN_ROIS, 14, 14, 1024), generator=gen,
                    device=dev).bfloat16()
    shape = (n, fh, fw)
    for name, line, fn, plain in (
        ("crop_and_resize_backward", 359,
         lambda: ra.crop_and_resize_backward(g, rois, idx, shape, 1 / 16),
         lambda: ra.crop_and_resize_backward_plain(g.float(), rois, idx,
                                                   shape, 1 / 16)),
        ("roi_pool_backward", 441,
         lambda: ra.roi_pool_backward(g, feats, rois, idx, 1 / 16),
         lambda: ra.roi_pool_backward_plain(g.float(), feats.float(), rois,
                                            idx, 1 / 16)),
    ):
        got, want = fn(), plain()
        label = f"{'K11' if 'crop' in name else 'K12'} {name} " \
                f"{tuple(g.shape)} -> {tuple(got.shape)}"
        # the float32 atomics' order: 1e-5 of the largest value
        err = compare(label, got, want, 1e-5 * want.abs().max().item())
        if not got.is_contiguous():
            raise AssertionError(f"{name}: the grad is not contiguous NHWC")
        ms = cuda_ms(torch, fn)
        plain_ms = cuda_ms(torch, plain, warmup=1, iters=2)
        print(f"{label}: kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms")
        results[name] = entry(name, line)
        results[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
    profile_train(torch, step, state, batch)
    return counts, ms, host_ms, peak_gb


def kernel_group(name):
    """Coarse family of a CUDA kernel's name, for the profile's table."""
    low = name.lower()
    for group, keys in (
        ("K1 roi_align fwd", ("roi_align_fwd",)),
        ("K7 roi_align bwd", ("roi_align_bwd",)),
        ("K5 crop_resize fwd", ("crop_resize_fwd",)),
        ("K11 crop_resize bwd", ("crop_resize_bwd",)),
        ("K6 roi_pool fwd", ("roi_pool_fwd",)),
        ("K12 roi_pool bwd", ("roi_pool_bwd",)),
        ("K2 nms", ("nms_mask", "nms_scan")),
        ("K8/K9 targets", ("anchor_", "proposal_match", "mask_crop")),
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(2):
            state, _ = step(state, batch, SEED)
        torch.cuda.synchronize()
    groups, names = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / 2
        names.append((ms, ev.count // 2, ev.key))
        g = groups.setdefault(kernel_group(ev.key), [0.0, 0])
        g[0] += ms
        g[1] += ev.count // 2
    total = sum(v[0] for v in groups.values())
    print(f"profile of 2 train steps, device time per step by kernel "
          f"family (ms, launches): total {total:.3f}")
    for name, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:30s} {ms:9.3f} {cnt:6d}")
    print("top kernels (ms per step, launches, name):")
    for ms, cnt, name in sorted(names, reverse=True)[:12]:
        print(f"  {ms:8.3f} {cnt:5d}  {name[:110]}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    check_train_kernels(torch, results)
    check_pool_kernels(torch, results)
    for pooling in POOLERS:
        check_small_reference(torch, pooling)
        check_train_reference(torch, pooling)

    # Each main path runs with its kernels' counts set to 0 just before it
    # and read just after; a kernel's "launches" sums its main-path runs.
    pool_fwd = {"align": roi_align.roi_align_grouped,
                "resize": roi_align.crop_and_resize,
                "pooling": roi_align.roi_pool}
    pool_bwd = {"align": roi_align.roi_align_grouped_backward,
                "resize": roi_align.crop_and_resize_backward,
                "pooling": roi_align.roi_pool_backward}
    launches, serving, training = {}, {}, {}

    def count(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    for pooling in POOLERS:
        counts, ms_img, step_ms = drive_main_path(
            torch, (pool_fwd[pooling], nms.nms_blocked, nms.nms_small),
            pooling)
        count(counts)
        serving[pooling] = {"predict_ms_per_img_b1": ms_img,
                            "predict_submit_ms_per_img_b1": step_ms}
    for pooling in POOLERS:
        counts, ms, host_ms, peak_gb = drive_train_path(
            torch, (pool_fwd[pooling], nms.nms_blocked, pool_bwd[pooling],
                    targets.mask_crop_resize, targets.anchor_match,
                    targets.proposal_match),
            pooling, reps=10 if pooling == "align" else 5)
        count(counts)
        training[pooling] = {"train_ms_per_step_b2": ms,
                             "train_img_per_s_b2": 2e3 / ms,
                             "train_host_ms_per_step_b2": host_ms,
                             "train_peak_gib": peak_gb, "launches": counts}
    launches["anchor_match"] += launches.pop("proposal_match")
    for name, entry in results.items():
        entry["launches"] = launches[name]

    print(json.dumps({"serving": serving, "training": training,
                      "card": smi}))
    order = ("roi_align_grouped", "nms_blocked", "nms_small",
             "roi_align_grouped_backward", "mask_crop_resize", "anchor_match",
             "crop_and_resize", "crop_and_resize_backward", "roi_pool",
             "roi_pool_backward")
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
