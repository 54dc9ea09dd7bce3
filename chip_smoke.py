#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mask_rcnn_tpu_torch``) on one NVIDIA
GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from ``mask_rcnn_tpu_torch/csrc``;
2. holds each kernel against its plain torch version on the card at the
   main path's shapes (RoIAlign K1 on (1, 52, 84, 1024) bf16 features with
   1000 and 100 rois; proposal NMS K2 6000 -> 1000 at 0.7; decode NMS K3
   80 x 256 -> 100 at 0.5) and times both with CUDA events;
3. checks the whole predict step on the GPU against the plain path on the
   CPU at a small float32 input;
4. drives ``MaskRCNNResNet.predict`` at R-50-C4, COCO (80 classes), anchor
   scales (2, 4, 8, 16, 32), min 800 / max 1333 (buckets 832x1344 and
   1344x832), bf16, seeded random weights: three single images, a batch of
   two, and a request at ``score_thresh=0``; checks the outputs and that
   every kernel was launched during that run.

Prints the card's name and power limit, one JSON line of kernel results,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, and
prints no result, when a phase fails or no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_CLASS_FG = 80


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


def check_small_reference(torch):
    """Phase 3: the predict step on the GPU (kernels) against the plain path
    on the CPU, float32, at a small input."""
    from mask_rcnn_tpu_torch.models import mask_rcnn, rpn
    from mask_rcnn_tpu_torch.models.mask_rcnn import map_params

    cfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=3, min_size=64, max_size=96, anchor_scales=(1.0, 2.0),
        detections_per_im=8,
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
        print(f"small f32 reference (GPU vs CPU plain): {k} max|err| "
              f"{err:.3e} (atol {atol:g})")
        assert err <= atol, f"{k} differs from the CPU reference by {err}"


def drive_main_path(torch, kernels):
    """Phase 4: the port's serving path at full width; returns the launch
    counts of the run and the steady ms per image."""
    from mask_rcnn_tpu_torch import MaskRCNNResNet
    from mask_rcnn_tpu_torch.data.loader import bucket_shape

    t0 = time.perf_counter()
    model = MaskRCNNResNet(
        n_layers=50, n_fg_class=N_CLASS_FG, min_size=800, max_size=1333,
        anchor_scales=(2, 4, 8, 16, 32), compute_dtype="bfloat16",
        rng_seed=SEED, device="cuda",
    )
    print(f"model built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)

    def image(h, w):
        return rng.uniform(0, 255, (3, h, w)).astype(np.float32)

    for wrapper in kernels:
        wrapper.launches = 0
    requests = [[image(640, 1066)], [image(480, 640)], [image(1066, 640)],
                [image(427, 640), image(640, 480)]]
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
    print(f"kernel launches during the main path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched")

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
    print(f"steady batch-1 predict (640x1066 -> 832x1344 bucket, bf16): "
          f"{ms_img:.3f} ms/img end to end (host clock, synchronised), "
          f"{step_ms:.3f} ms/img prepare+predict_step (CUDA events)")
    return counts, ms_img, step_ms


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
    from mask_rcnn_tpu_torch.ops import _kernels, nms, roi_align

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
    check_small_reference(torch)
    kernels = (roi_align.roi_align_grouped, nms.nms_blocked, nms.nms_small)
    counts, ms_img, step_ms = drive_main_path(torch, kernels)

    for name, c in counts.items():
        results[name]["launches"] = c
    print(json.dumps({"predict_ms_per_img_b1": ms_img,
                      "predict_submit_ms_per_img_b1": step_ms, "card": smi}))
    print(json.dumps({"kernels": [results[w.__name__] for w in kernels]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
