"""Batch assembly: static bucket shapes, mask bit-packing, padded batches
and the prefetching train loader, numpy copies of
``mask_rcnn_tpu/data/loader.py`` (importing that package would import jax).

  * images zero-padded into one of two orientation buckets (landscape /
    portrait) derived from (min_size, max_size), rounded up to 64;
  * gt boxes/labels/masks padded to ``max_boxes`` with validity masks;
  * a deterministic per-process slice of each global batch.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator, Sequence

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_shape(h: int, w: int, min_size: int, max_size: int):
    """The static padded shape for a resized (h, w) image: orientation
    bucket with short side >= min_size, long side >= max_size, 64-aligned."""
    short = round_up(min_size, 64)
    long_ = round_up(max_size, 64)
    if w >= h:
        return (short if h <= short else round_up(h, 64),
                long_ if w <= long_ else round_up(w, 64))
    return (long_ if h <= long_ else round_up(h, 64),
            short if w <= short else round_up(w, 64))


def pack_mask_bits(mask: np.ndarray) -> np.ndarray:
    """(..., W) binary -> (..., W/8) uint8 bit-packed along the last axis
    (``np.packbits`` order: the first column is the high bit). The train
    step reads the packed form directly (kernel K8)."""
    if mask.shape[-1] % 8:
        raise ValueError(f"mask width must be a multiple of 8: {mask.shape}")
    return np.packbits(mask.astype(bool), axis=-1)


def pad_batch(
    examples: Sequence,
    max_boxes: int,
    min_size: int,
    max_size: int,
    pack_masks: bool = True,
    image_fill=None,
    force_shape=None,
) -> Dict[str, np.ndarray]:
    """Transformed examples [(img, bbox, label, mask, scale), ...] ->
    padded batch dict (all images share one bucket = max over the batch).

    ``image_fill``: per-channel fill for the padded image margin. uint8
    images (keep_uint8 transforms, 4x less H2D; the train step casts +
    mean-subtracts on device) should pass the rounded pixel mean so the
    margin lands at ~0 post-subtraction, like the float path's zeros.

    ``force_shape``: explicit (hp, wp) padded extent. Multi-process
    training must use this: each process pads its own slice of the global
    batch, and every process must produce the same local shape."""
    n = len(examples)
    if force_shape is not None:
        hp, wp = force_shape
        for e in examples:
            if e[0].shape[0] > hp or e[0].shape[1] > wp:
                raise ValueError(
                    f"image {e[0].shape[:2]} exceeds forced pad shape "
                    f"({hp}, {wp})"
                )
    else:
        shapes = [
            bucket_shape(e[0].shape[0], e[0].shape[1], min_size, max_size)
            for e in examples
        ]
        hp = max(s[0] for s in shapes)
        wp = max(s[1] for s in shapes)

    img_dtype = np.asarray(examples[0][0]).dtype
    images = np.zeros(
        (n, hp, wp, 3),
        np.uint8 if img_dtype == np.uint8 else np.float32,
    )
    if image_fill is not None:
        images[:] = np.asarray(image_fill, images.dtype)
    bbox = np.zeros((n, max_boxes, 4), np.float32)
    label = np.zeros((n, max_boxes), np.int32)
    bbox_valid = np.zeros((n, max_boxes), bool)
    mask = np.zeros((n, max_boxes, hp, wp), np.uint8)
    scale = np.zeros((n,), np.float32)

    for i, (img, b, l, m, s) in enumerate(examples):
        h, w = img.shape[:2]
        images[i, :h, :w] = img
        g = min(len(b), max_boxes)
        if g:
            bbox[i, :g] = b[:g]
            label[i, :g] = l[:g]
            bbox_valid[i, :g] = True
            mask[i, :g, :h, :w] = m[:g]
        scale[i] = s
    return {
        "image": images,
        "bbox": bbox,
        "label": label,
        "bbox_valid": bbox_valid,
        "mask": pack_mask_bits(mask) if pack_masks else mask,
        "scale": scale,
    }


class TrainLoader:
    """Shuffled epoch iterator producing padded batches, with per-process
    slicing of each global batch and background prefetch (one worker
    thread; decode and transform run in numpy, so a thread overlaps them
    with device steps). The index sequence, aspect grouping, resume walk and
    prefetch are the JAX package's (mask_rcnn_tpu/data/loader.py:122-373).
    Under data parallelism each rank builds it with its ``process_index``
    and the group's ``process_count`` at one device's batch, and pads to
    ``_batch_force_shape`` so every rank's batch has one shape."""

    def __init__(
        self,
        dataset,
        transform,
        batch_size: int,
        max_boxes: int = 64,
        min_size: int = 600,
        max_size: int = 1000,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.min_size = min_size
        self.max_size = max_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # Aspect-ratio grouping (Detectron-style): batching portrait with
        # landscape pads both to a square worst-case bucket (~45% wasted
        # compute + an extra compiled graph). If the dataset exposes cheap
        # per-image sizes (COCO json does), group orientations per batch.
        self.aspect_flags = None
        sizes = getattr(dataset, "image_sizes", None)
        if callable(sizes):
            try:
                sizes = sizes()
            except AttributeError:
                # composite datasets (ConcatDataset) raise when a child
                # lacks the metadata — same as not exposing it at all
                sizes = None
        if sizes is not None and len(sizes) == len(dataset):
            self.aspect_flags = np.asarray(
                [s[1] >= s[0] for s in sizes], bool
            )  # True = landscape
        elif min_size != max_size and len(dataset) > 1:
            # A non-square resize target means image orientation decides the
            # padded bucket; without grouping every mixed batch pads to the
            # square worst case (and multi-process force_shape degrades to
            # (long, long)). Warn loudly rather than silently burn ~45%.
            import warnings

            reason = (
                "returned a list whose length does not match the dataset"
                if sizes is not None
                else "is not exposed"
            )
            warnings.warn(
                f"TrainLoader: aspect-ratio grouping disabled — "
                f"{type(dataset).__name__}.image_sizes {reason}. Mixed-"
                f"orientation batches pad to the square worst case "
                f"({round_up(max_size, 64)}, {round_up(max_size, 64)}); "
                f"expose image_sizes() -> [(H, W), ...] to fix.",
                stacklevel=2,
            )

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's index sequence for ``epoch``; batch ``b`` is the
        slice ``[b*batch_size:(b+1)*batch_size]``.

        Every process computes the same global batch sequence (global
        shuffle -> whole global batches of ``batch_size * process_count`` ->
        shuffled batch order) and takes its contiguous slice within each
        global batch, so at every step all processes work on slices of one
        global batch; with aspect grouping the global batches are
        orientation-uniform, which keeps every process's padded shape equal.
        """
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(len(self.dataset))
        g = self.batch_size * self.process_count
        if self.aspect_flags is not None:
            # Partition the global order by orientation, form whole global
            # batches within each group, then shuffle batch order. The
            # per-group remainders (< g each) are dropped this epoch
            # (recorded and logged). The orientation partition is static,
            # so the drop — and the per-epoch batch count — is the same
            # every epoch.
            land = idx[self.aspect_flags[idx]]
            port = idx[~self.aspect_flags[idx]]
            batches = [
                grp[i:i + g]
                for grp in (land, port)
                for i in range(0, len(grp) - g + 1, g)
            ]
        else:
            batches = [
                idx[i:i + g] for i in range(0, len(idx) - g + 1, g)
            ]
        order = rng.permutation(len(batches))
        self._last_drop = len(idx) - len(batches) * g
        lo = self.process_index * self.batch_size
        hi = lo + self.batch_size
        if batches:
            return np.concatenate([batches[i][lo:hi] for i in order])
        return idx[:0]

    def batches_in_epoch(self, epoch: int) -> int:
        return len(self.epoch_indices(epoch)) // self.batch_size

    def position_for_step(self, global_step: int):
        """(epoch, step-within-epoch) after ``global_step`` completed steps.

        Walks actual per-epoch batch counts instead of dividing by a
        constant — global batch formation makes the counts constant today,
        but the walk keeps resume correct for any loader subclass whose
        epochs vary (and for zero-batch epochs, which contribute no steps).
        """
        epoch, remaining = 0, global_step
        zero_run = 0
        while True:
            n = self.batches_in_epoch(epoch)
            if n > 0:
                zero_run = 0
                if remaining < n:
                    return epoch, remaining
                remaining -= n
            else:
                # An epoch whose shuffle forms no whole batches contributes
                # no steps — the train loop skips straight past it, so the
                # walk must too (returning (epoch, 0) here would replay
                # later epochs' already-consumed batches after a resume).
                zero_run += 1
                if zero_run >= 1000:
                    if remaining:
                        raise RuntimeError(
                            f"cannot locate step {global_step}: {zero_run} "
                            "consecutive epochs form no batches (checkpoint "
                            "from a different loader configuration?)"
                        )
                    return epoch, 0
            epoch += 1

    def _batch_force_shape(self, batch_idx):
        """Deterministic padded extent for a multi-process batch: the
        orientation bucket of the (orientation-uniform) global batch, or the
        square worst case without size metadata."""
        if self.process_count == 1:
            return None
        short = round_up(self.min_size, 64)
        long_ = round_up(self.max_size, 64)
        if self.aspect_flags is not None:
            landscape = bool(self.aspect_flags[int(batch_idx[0])])
            return (short, long_) if landscape else (long_, short)
        return (long_, long_)

    def _make_batches(
        self, epoch: int, skip: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch)
        nb = len(idx) // self.batch_size
        dropped = getattr(self, "_last_drop", 0)
        if dropped and skip == 0:
            print(
                f"[TrainLoader] epoch {epoch}: {dropped} image(s) dropped "
                f"globally by batch formation (aspect-group/batch "
                f"remainder), {nb} batches kept"
            )
        # uint8 transforms: pad the image margin at the (rounded) pixel
        # mean so it lands at ~0 after on-device mean subtraction.
        fill = None
        if getattr(self.transform, "keep_uint8", False):
            fill = np.round(self.transform.mean).astype(np.uint8)
        # Resume fast-forward skips at the index level: no decode/transform
        # runs for skipped batches.
        for b in range(skip, nb):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
            examples = [
                self.transform(self.dataset[int(i)]) for i in batch_idx
            ]
            yield pad_batch(
                examples, self.max_boxes, self.min_size, self.max_size,
                image_fill=fill,
                force_shape=self._batch_force_shape(batch_idx),
            )

    def epoch(
        self, epoch: int, skip: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator over one epoch (optionally resuming after
        ``skip`` already-consumed batches). A decode/transform error in the
        worker thread is re-raised here — the epoch must not silently end
        early on a bad example."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # Stop-aware put: a consumer that abandons the generator early
            # (stop_at_step, final-epoch break) sets ``stop``; without the
            # timeout loop the worker would block forever on the full
            # queue, leaking the thread and `prefetch` decoded batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._make_batches(epoch, skip):
                    if not put(batch):
                        return
            except BaseException as e:  # surfaced in the consumer
                put(e)
            else:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        f"TrainLoader worker failed in epoch {epoch}"
                    ) from item
                yield item
        finally:
            stop.set()
            t.join()

    def steps_per_epoch(self) -> int:
        """Nominal batches per epoch (the first epoch that forms any;
        counts are constant under global batch formation, but subclasses
        with varying epochs stay supported)."""
        for e in range(1000):
            n = len(self.epoch_indices(e)) // self.batch_size
            if n:
                return n
        return 0
