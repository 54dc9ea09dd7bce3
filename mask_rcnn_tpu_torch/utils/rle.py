"""COCO-compatible RLE mask codec (numpy), the port of
``mask_rcnn_tpu/utils/rle.py``.

The pycocotools mask RLE format (column-major run lengths with the
LEB128-style delta string encoding), so COCO-format annotations and results
round-trip without the pycocotools C extension. Counts come from the native
encoder (``utils/native.py``) when it builds, else from numpy.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (H, W) mask -> run lengths of alternating 0/1 in column-major
    order, starting with zeros."""
    from mask_rcnn_tpu_torch.utils import native

    fast = native.rle_encode(np.asarray(mask))
    if fast is not None:
        return fast
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros((0,), np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], change, [n]])
    counts = np.diff(boundaries)
    if flat[0] == 1:  # must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def rle_counts_to_mask(counts, size) -> np.ndarray:
    h, w = size
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != H*W {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((w, h)).T  # column-major


def encode_counts_string(counts) -> bytes:
    """pycocotools LEB128-style string encoding with deltas from i-2."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode_counts_string(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode_mask(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> COCO RLE dict with compressed string counts."""
    h, w = mask.shape
    return {
        "size": [int(h), int(w)],
        "counts": encode_counts_string(mask_to_rle_counts(mask)),
    }


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed string or uncompressed list) -> (H, W)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = decode_counts_string(counts)
    return rle_counts_to_mask(counts, rle["size"])


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = decode_counts_string(counts)
    return int(np.asarray(counts[1::2]).sum())


def rle_iou(dets: List[Dict], gts: List[Dict], iscrowd: List[bool]
            ) -> np.ndarray:
    """Pairwise mask IoU (D, G) from RLE dicts; crowd gts use union=det area
    (pycocotools ``maskUtils.iou`` analog). Decode + the single production
    IoU implementation — crowd semantics live in one place
    (``cocoeval.mask_iou_matrix``), not a third copy here."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    from mask_rcnn_tpu_torch.utils.cocoeval import mask_iou_matrix

    det_masks = np.stack([decode_rle(r).astype(bool) for r in dets])
    gt_masks = np.stack([decode_rle(r).astype(bool) for r in gts])
    return mask_iou_matrix(
        det_masks, gt_masks, np.asarray(iscrowd, bool)
    )
