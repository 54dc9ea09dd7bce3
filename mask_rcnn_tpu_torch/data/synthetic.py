"""Synthetic data, numpy copies of ``mask_rcnn_tpu/data/synthetic.py``
(importing that package would import jax): in-memory train batches, and
on-disk COCO and SBD roots.

The COCO root is a tiny but real COCO directory tree — PNG image files plus
``annotations/instances_*.json`` with polygon, compressed-RLE,
uncompressed-RLE and crowd annotations — so the COCO drivers
(``examples/coco/train.py`` -> ``evaluate.py``) run end to end without
downloads. Shapes are axis-aligned color-coded primitives on a dark noisy
background (one category per shape kind, non-contiguous COCO category ids
to exercise the id->class mapping). The same seed gives the JAX
generator's JSON and pixels; the PNGs are written by the port's own
encoder (``data/_image.py::write_png``), so the root can be made where
cv2 is missing. The SBD root is its VOC analog (JPEG + ``.mat``).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from mask_rcnn_tpu_torch.data._image import write_jpeg, write_png
from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
from mask_rcnn_tpu_torch.utils import rle as rle_util

# Non-contiguous category ids, like real COCO (ids 1..90 with holes).
CATEGORIES = [
    {"id": 1, "name": "box"},
    {"id": 3, "name": "disk"},
    {"id": 7, "name": "stripe"},
]
_COLORS = {1: (230, 60, 50), 3: (60, 220, 70), 7: (70, 90, 235)}


def _place_shape(rng, img, occupied, cat_id):
    """Draw one shape; returns (mask, ann_patch) or None if placement
    failed. ``ann_patch`` is the segmentation encoding to embed in JSON —
    polygons for boxes, compressed RLE for disks, uncompressed RLE for
    stripes, covering all three decode paths of
    COCOInstanceSegmentationDataset.segmentation_to_mask."""
    h, w = img.shape[:2]
    s = max(min(h, w) // 96, 1)  # shape sizes track the canvas size
    # Largest extent that still leaves the 2px border randint() needs
    # (y1 in [2, h-bh-2) requires bh <= h-5); clamping keeps small
    # --image-hw canvases working instead of crashing in randint.
    max_h, max_w = h - 5, w - 5
    for _ in range(20):
        if cat_id == 1:  # rectangle, polygon segmentation
            bh, bw = s * rng.randint(18, 30), s * rng.randint(18, 34)
        elif cat_id == 3:  # disk, compressed RLE
            r = s * rng.randint(9, 14)
            r = min(r, (min(max_h, max_w) - 1) // 2)
            bh = bw = 2 * r + 1
        else:  # wide stripe, uncompressed RLE
            bh, bw = s * rng.randint(10, 14), s * rng.randint(34, 48)
        bh, bw = min(bh, max_h), min(bw, max_w)
        y1 = rng.randint(2, h - bh - 2)
        x1 = rng.randint(2, w - bw - 2)
        if occupied[y1:y1 + bh, x1:x1 + bw].any():
            continue
        mask = np.zeros((h, w), bool)
        if cat_id == 1:
            # PIL polygon(outline=1, fill=1) over integer corners fills the
            # boundary inclusively: corners (x1, y1)..(x2, y2) -> pixels
            # [y1:y2+1, x1:x2+1] (data/coco.py::polygons_to_mask).
            y2, x2 = y1 + bh - 1, x1 + bw - 1
            mask[y1:y2 + 1, x1:x2 + 1] = True
            segm = [[float(x1), float(y1), float(x2), float(y1),
                     float(x2), float(y2), float(x1), float(y2)]]
        elif cat_id == 3:
            yy, xx = np.mgrid[:h, :w]
            r = bh // 2
            cy, cx = y1 + r, x1 + r
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            enc = rle_util.encode_mask(mask)
            segm = {"size": enc["size"],
                    "counts": enc["counts"].decode("ascii")}
        else:
            mask[y1:y1 + bh, x1:x1 + bw] = True
            counts = rle_util.mask_to_rle_counts(mask)
            segm = {"size": [h, w], "counts": [int(c) for c in counts]}
        img[mask] = _COLORS[cat_id]
        occupied[y1 - 2:y1 + bh + 2, x1 - 2:x1 + bw + 2] = True
        return mask, segm
    return None


def _make_split(rng, img_dir, prefix, n_images, height, width,
                first_img_id, first_ann_id, with_crowd=False):
    images, annotations = [], []
    img_id, ann_id = first_img_id, first_ann_id
    for i in range(n_images):
        img = rng.randint(0, 60, (height, width, 3)).astype(np.uint8)
        occupied = np.zeros((height, width), bool)
        file_name = f"COCO_{prefix}_{img_id:012d}.png"
        n_shapes = rng.randint(2, 4)
        cat_ids = [CATEGORIES[rng.randint(len(CATEGORIES))]["id"]
                   for _ in range(n_shapes)]
        for cat_id in cat_ids:
            placed = _place_shape(rng, img, occupied, cat_id)
            if placed is None:
                continue
            mask, segm = placed
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": cat_id,
                "segmentation": segm,
                "iscrowd": 0,
                "area": float(mask.sum()),
            })
            ann_id += 1
        if with_crowd and i == 0:
            # one crowd region (RLE, like real COCO crowds): a dim block
            # the model should neither be required to find nor be punished
            # for matching (use_crowd=True + iscrowd=1 ignore semantics)
            cm = np.zeros((height, width), bool)
            cm[height - 12:height - 2, 2:26] = ~occupied[
                height - 12:height - 2, 2:26]
            img[cm] = (120, 120, 120)
            enc = rle_util.encode_mask(cm)
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": 1,
                "segmentation": {"size": enc["size"],
                                 "counts": enc["counts"].decode("ascii")},
                "iscrowd": 1,
                "area": float(cm.sum()),
            })
            ann_id += 1
        write_png(osp.join(img_dir, file_name), img)
        images.append({"id": img_id, "file_name": file_name,
                       "height": height, "width": width})
        img_id += 1
    return images, annotations, img_id, ann_id


def make_synthetic_coco_root(
    dst: str,
    n_train: int = 8,
    n_valminusminival: int = 2,
    n_minival: int = 4,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
) -> str:
    """Write a complete synthetic COCO_ROOT under ``dst`` and return it."""
    if min(height, width) < 16:
        raise ValueError(
            f"canvas {height}x{width} too small: shapes need a >=3px "
            "extent inside a 2px border (min dimension 16)"
        )
    rng = np.random.RandomState(seed)
    train_dir = osp.join(dst, "train2014")
    val_dir = osp.join(dst, "val2014")
    ann_dir = osp.join(dst, "annotations")
    for d in (train_dir, val_dir, ann_dir):
        os.makedirs(d, exist_ok=True)

    img_id, ann_id = 1, 1
    splits = {}
    for split, img_dir, prefix, n, crowd in (
        ("train2014", train_dir, "train2014", n_train, False),
        ("valminusminival2014", val_dir, "val2014", n_valminusminival,
         False),
        ("minival2014", val_dir, "val2014", n_minival, True),
    ):
        images, anns, img_id, ann_id = _make_split(
            rng, img_dir, prefix, n, height, width, img_id, ann_id,
            with_crowd=crowd,
        )
        splits[split] = {"images": images, "annotations": anns,
                         "categories": CATEGORIES}
    for split, payload in splits.items():
        with open(osp.join(ann_dir, f"instances_{split}.json"), "w") as f:
            json.dump(payload, f)
    return dst


def make_synthetic_train_batch(n, h, w, rng, max_boxes=8, n_fg_class=80):
    """In-memory padded train batch at (n, h, w): random images,
    ``max_boxes`` axis-aligned gt rectangles per image with matching
    bit-packed masks. ``rng`` is a ``np.random.RandomState``; the same seed
    gives the JAX package's batch."""
    g = max_boxes
    images = (rng.randn(n, h, w, 3) * 60).astype(np.float32)
    bbox = np.zeros((n, g, 4), np.float32)
    label = np.zeros((n, g), np.int32)
    valid = np.ones((n, g), bool)
    mask = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1 = rng.randint(0, h - 200)
            x1 = rng.randint(0, w - 200)
            y2, x2 = y1 + rng.randint(60, 200), x1 + rng.randint(60, 200)
            bbox[i, k] = (y1, x1, y2, x2)
            label[i, k] = rng.randint(0, n_fg_class)
            mask[i, k, y1:y2, x1:x2] = 1
    return {
        "image": images,
        "bbox": bbox,
        "label": label,
        "bbox_valid": valid,
        "mask": pack_mask_bits(mask),
        "scale": np.full((n,), 1.25, np.float32),
    }


# ---------------------------------------------------------------------------
# Synthetic SBD root (benchmark_RELEASE/dataset layout)
# ---------------------------------------------------------------------------

# Three of the 20 VOC classes, color-coded so a from-scratch model can
# overfit quickly (same idea as the COCO generator above).
SBD_CLASS_IDS = (1, 8, 15)  # aeroplane, cat, person
_SBD_COLORS = {1: (230, 60, 50), 8: (60, 220, 70), 15: (70, 90, 235)}


def _sbd_image(rng, height, width):
    """One synthetic SBD example: RGB image + class/instance label images
    (uint8, 0 = background, 255 = void), 2-3 shapes of the color-coded
    classes plus a void border strip to exercise 255 -> -1 handling
    (reference datasets/voc/sbd.py:47-53)."""
    img = rng.randint(0, 60, (height, width, 3)).astype(np.uint8)
    cls = np.zeros((height, width), np.uint8)
    ins = np.zeros((height, width), np.uint8)
    occupied = np.zeros((height, width), bool)
    inst_id = 1
    for _ in range(rng.randint(2, 4)):
        cid = SBD_CLASS_IDS[rng.randint(len(SBD_CLASS_IDS))]
        for _attempt in range(20):
            bh = rng.randint(height // 5, height // 2)
            bw = rng.randint(width // 5, width // 2)
            y1 = rng.randint(1, height - bh - 1)
            x1 = rng.randint(1, width - bw - 1)
            if occupied[y1:y1 + bh, x1:x1 + bw].any():
                continue
            if cid == 8:  # disk
                yy, xx = np.mgrid[:height, :width]
                r = min(bh, bw) // 2
                m = (yy - (y1 + r)) ** 2 + (xx - (x1 + r)) ** 2 <= r * r
            else:  # rectangle
                m = np.zeros((height, width), bool)
                m[y1:y1 + bh, x1:x1 + bw] = True
            img[m] = _SBD_COLORS[cid]
            cls[m] = cid
            ins[m] = inst_id
            occupied[max(y1 - 2, 0):y1 + bh + 2,
                     max(x1 - 2, 0):x1 + bw + 2] = True
            inst_id += 1
            break
    # void strip on the top border (both label images), like real SBD edges
    cls[0, :] = 255
    ins[0, :] = 255
    return img, cls, ins


def make_synthetic_sbd_root(
    dst: str,
    n_train: int = 8,
    n_val: int = 4,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
) -> str:
    """Write a complete synthetic SBD root (benchmark_RELEASE/dataset
    layout: img/*.jpg + cls/inst GTcls/GTinst .mat structs + SDS-layout
    ImageSets/Main/{train,val}.txt split lists) under ``dst`` and return
    it. Drives the unmodified VOC/SBD example drivers end-to-end without
    network egress — the VOC analog of make_synthetic_coco_root. The
    JPEGs are written by cv2, as the JAX generator writes them, else by
    PIL (``data/_image.py::write_jpeg``); without either this raises
    ``ImportError``."""
    import scipy.io

    if min(height, width) < 16:
        raise ValueError(f"canvas {height}x{width} too small (min dim 16)")
    rng = np.random.RandomState(seed)
    for d in ("img", "cls", "inst", "ImageSets/Main"):
        os.makedirs(osp.join(dst, d), exist_ok=True)

    counter = 1
    for split, n in (("train", n_train), ("val", n_val)):
        ids = []
        for _ in range(n):
            did = f"2008_{counter:06d}"
            counter += 1
            ids.append(did)
            img, cls, ins = _sbd_image(rng, height, width)
            # JPEG is lossy; the color-coded classes stay separable
            write_jpeg(osp.join(dst, "img", did + ".jpg"), img)
            scipy.io.savemat(osp.join(dst, "cls", did + ".mat"),
                             {"GTcls": {"Segmentation": cls}})
            scipy.io.savemat(osp.join(dst, "inst", did + ".mat"),
                             {"GTinst": {"Segmentation": ins}})
        with open(osp.join(dst, "ImageSets/Main", split + ".txt"),
                  "w") as f:
            f.write("".join(i + "\n" for i in ids))
    return dst
