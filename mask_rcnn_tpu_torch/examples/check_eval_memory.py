"""COCO-scale evaluation memory check, the port of
``examples/check_eval_memory.py``.

Runs the port's streaming ``engine/evaluator.py::
InstanceSegmentationEvaluator`` over a synthetic dataset at COCO-minival
scale (default 5000 images, ~1 MP, up to 100 detections each) with a fake
predict, and reports the peak RSS. An evaluator that held every
full-resolution mask in RAM would need ~100+ GB at this scale; the
streaming path must stay within a few GB. ``--raw`` scores through
``predict_submit``/``predict_collect_raw`` and ``add_boxlocal`` (boxes
and 14x14 roi probabilities, no full-image paste), the path the port's
``MaskRCNNResNet`` takes. Host only: no model, no card.

The JAX script's bound holds (a peak under ``--rss-limit-gb``), on this
process's own memory: the resident set (``VmRSS`` of
``/proc/self/status``, sampled on a thread) less the mapped files
resident before the sweep (``/proc/self/smaps``). The port's package
imports torch, and on the H100's machine torch's CUDA build puts 4.65 GB
of shared libraries in the resident set at import (``libtorch_cuda``
0.86 GB, ``libcublasLt`` 0.73, ``libcusparseLt`` 0.44, ...), none of it
the evaluator's. ``ru_maxrss`` and ``VmHWM`` are not read: Linux carries
a parent's resident set into the high-water mark of a process it starts.
The sweep's growth must also stay under :data:`GROWTH_LIMIT_GB`, set from
the JAX script's record (a whole-process peak of 0.96-1.17 GB at 5000
images).

    python -m mask_rcnn_tpu_torch.examples.check_eval_memory \
        [--images 5000] [--dets 100] [--raw]
"""

from __future__ import annotations

import argparse
import resource
import sys
import threading
import time

import numpy as np

# The sweep's growth limit: the JAX script's whole process peaked at
# 0.96-1.17 GB over 5000 images; a few times that is a leak, not noise.
GROWTH_LIMIT_GB = 3.0


class SyntheticCOCOScaleDataset:
    """~1 MP images with a handful of rectangular gt instances."""

    def __init__(self, n: int, h: int = 800, w: int = 1216, n_gt: int = 8):
        self.n, self.h, self.w, self.n_gt = n, h, w, n_gt

    def __len__(self):
        return self.n

    def _boxes(self, i):
        rng = np.random.RandomState(i)
        boxes = []
        for _ in range(self.n_gt):
            y = rng.randint(0, self.h - 120)
            x = rng.randint(0, self.w - 120)
            boxes.append((y, x, y + rng.randint(40, 120),
                          x + rng.randint(40, 120)))
        return boxes, rng

    def __getitem__(self, i):
        boxes, rng = self._boxes(i)
        img = np.full((self.h, self.w, 3), 127, np.uint8)
        masks = np.zeros((self.n_gt, self.h, self.w), np.int32)
        for k, (y1, x1, y2, x2) in enumerate(boxes):
            masks[k, y1:y2, x1:x2] = 1
        bboxes = np.asarray(boxes, np.float32)
        labels = rng.randint(0, 80, self.n_gt).astype(np.int32)
        crowds = np.zeros(self.n_gt, np.int32)
        areas = masks.sum(axis=(1, 2)).astype(np.float32)
        # stash for the fake model (keyed by image checksum is overkill;
        # the model re-derives from the image index channel below)
        # index encoded across three channel-0 pixels so every image (not
        # just the first 251) round-trips exactly through the fake model,
        # which reads the CHW-transposed image at [0, 0, 0:3]
        img[0, 0, 0] = i % 251
        img[0, 1, 0] = (i // 251) % 251
        img[0, 2, 0] = i // (251 * 251)
        return img, bboxes, labels, masks, crowds, areas


class FakePredictModel:
    """Up to ``n_dets`` detections per image: jittered gt + noise."""

    def __init__(self, dataset, n_dets: int):
        self.dataset = dataset
        self.n_dets = n_dets

    def predict(self, imgs):
        bboxes, masks, labels, scores = [], [], [], []
        for img in imgs:
            h, w = img.shape[1:]
            i = (int(img[0, 0, 0]) + 251 * int(img[0, 0, 1])
                 + 251 * 251 * int(img[0, 0, 2]))
            boxes, rng = self.dataset._boxes(i)
            ms = np.zeros((self.n_dets, h, w), bool)
            ls = rng.randint(0, 80, self.n_dets).astype(np.int32)
            ss = rng.rand(self.n_dets).astype(np.float32)
            for k in range(self.n_dets):
                if k < len(boxes):
                    y1, x1, y2, x2 = boxes[k]
                    dy, dx = rng.randint(-6, 7, 2)
                    ms[k, max(y1 + dy, 0):y2 + dy,
                       max(x1 + dx, 0):x2 + dx] = True
                else:
                    y = rng.randint(0, h - 60)
                    x = rng.randint(0, w - 60)
                    ms[k, y:y + 50, x:x + 50] = True
            bboxes.append(np.zeros((self.n_dets, 4), np.float32))
            masks.append(ms)
            labels.append(ls)
            scores.append(ss)
        return bboxes, masks, labels, scores


class FakeRawPredictModel(FakePredictModel):
    """Same detections as boxes + (14, 14) roi probabilities — the form the
    production api layer hands the evaluator (``predict_collect_raw``), so
    the sweep scores via ``add_boxlocal`` without any full-image paste."""

    score_thresh = 0.0

    def predict_submit(self, imgs):
        out = []
        for img in imgs:
            h, w = img.shape[1:]
            i = (int(img[0, 0, 0]) + 251 * int(img[0, 0, 1])
                 + 251 * 251 * int(img[0, 0, 2]))
            boxes, rng = self.dataset._boxes(i)
            bb = np.zeros((self.n_dets, 4), np.float32)
            for k in range(self.n_dets):
                if k < len(boxes):
                    y1, x1, y2, x2 = boxes[k]
                    dy, dx = rng.randint(-6, 7, 2)
                    bb[k] = (max(y1 + dy, 0), max(x1 + dx, 0),
                             min(y2 + dy, h), min(x2 + dx, w))
                else:
                    y = rng.randint(0, h - 60)
                    x = rng.randint(0, w - 60)
                    bb[k] = (y, x, y + 50, x + 50)
            pr = np.full((self.n_dets, 14, 14), 0.9, np.float32)
            ls = rng.randint(0, 80, self.n_dets).astype(np.int32)
            ss = rng.rand(self.n_dets).astype(np.float32)
            out.append((bb, pr, ls, ss, (h, w)))
        return out

    def predict_collect_raw(self, handle):
        return (
            [x[0] for x in handle],
            [x[1] for x in handle],
            [x[2] for x in handle],
            [x[3] for x in handle],
            [x[4] for x in handle],
        )


def _rss_now_gb():
    """This process's resident set now (Linux's ``VmRSS``) in GB, or None
    where ``/proc`` has none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return None


def _mapped_files_gb():
    """The resident part of this process's file mappings (shared
    libraries, in ``/proc/self/smaps``) in GB, or 0.0 where ``/proc`` has
    none."""
    total, path = 0, None
    try:
        with open("/proc/self/smaps") as f:
            for line in f:
                head = line.split(None, 5)
                if not head[0].endswith(":"):  # a mapping: range perms ...
                    path = head[5].strip() if len(head) > 5 else ""
                elif head[0] == "Rss:" and path and path[0] != "[":
                    total += int(head[1])
    except OSError:
        pass
    return total * 1024 / 1e9


def measure_rss(fn):
    """(fn(), start GB, peak GB): the resident set sampled every 10 ms on a
    thread while ``fn`` runs; where ``/proc`` has no ``VmRSS``, the JAX
    script's ``ru_maxrss`` before and after."""
    start = _rss_now_gb()
    if start is None:
        def maxrss():
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        start = maxrss()
        out = fn()
        return out, start, maxrss()
    peak = [start]
    done = threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], _rss_now_gb())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        out = fn()
    finally:
        done.set()
        thread.join()
    return out, start, max(peak[0], _rss_now_gb())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=int, default=5000)
    parser.add_argument("--dets", type=int, default=100)
    parser.add_argument("--rss-limit-gb", type=float, default=8.0)
    parser.add_argument(
        "--raw", action="store_true",
        help="score via raw (box, roi-probs) detections / add_boxlocal — "
             "the production evaluator path (no full-image paste)",
    )
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
    )

    ds = SyntheticCOCOScaleDataset(args.images)
    model = (FakeRawPredictModel if args.raw else FakePredictModel)(
        ds, args.dets)
    class_names = [f"c{i}" for i in range(80)]
    ev = InstanceSegmentationEvaluator(ds, class_names, kind="coco",
                                       batch_size=4)
    files = _mapped_files_gb()
    t0 = time.time()
    report, rss0, peak = measure_rss(lambda: ev(model))
    dt = time.time() - t0
    end = _rss_now_gb()
    naive_gb = args.images * args.dets * 800 * 1216 / 1e9
    print(f"images={args.images} dets/img={args.dets}")
    print(f"map={report.get('validation/main/map', float('nan')):.4f}")
    print(f"elapsed: {dt:.1f}s ({args.images / dt:.1f} img/s scoring)")
    print(f"peak RSS: {peak - files:.2f} GB of this process's own (limit "
          f"{args.rss_limit_gb:g}) beside {files:.2f} GB of mapped files; "
          f"growth {peak - rss0:.2f} GB (limit {GROWTH_LIMIT_GB:g}) from "
          f"{rss0:.2f}, {end if end is None else round(end, 2)} GB after "
          f"the sweep; mask bytes if retained as lists: ~{naive_gb:.0f} GB")
    ok = peak - files < args.rss_limit_gb and peak - rss0 < GROWTH_LIMIT_GB
    print("RSS BOUNDED: " + ("OK" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
