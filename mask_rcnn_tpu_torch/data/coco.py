"""COCO instance-segmentation dataset (native JSON parsing, no pycocotools),
the port of ``mask_rcnn_tpu/data/coco.py`` without cv2 or PIL.

Capability parity with reference datasets/coco.py:19-208: 2014 splits
including train/val/minival/valminusminival, contiguous category ids,
images-without-annotations filtered, polygon segmentations rasterized and
RLE decoded, bbox recomputed from the mask, optional crowd/area returns.
Images are read by ``data/_image.py::read_rgb`` and polygons rasterized by
:func:`polygons_to_mask`, a numpy copy of PIL's polygon fill. Nothing is
downloaded: ``DOWNLOAD_URLS`` only names the archives.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np

from mask_rcnn_tpu_torch.data._image import read_rgb
from mask_rcnn_tpu_torch.utils import rle as rle_util
from mask_rcnn_tpu_torch.utils.geometry import mask_to_bbox

_F32 = np.float32


def _round_up(v: np.ndarray) -> np.ndarray:
    """PIL's ``ROUND_UP`` of float32 values: half away from zero, the
    half added in float32."""
    a = np.abs(v)
    r = np.floor(a + _F32(0.5))
    return np.where(v >= 0, r, -r).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """PIL's ``ROUND_DOWN``: half toward zero, the half taken in float32."""
    a = np.abs(v)
    r = np.ceil(a - _F32(0.5))
    return np.where(v >= 0, r, -r).astype(np.int64)


def _roundf(v: float) -> float:
    """C ``roundf``: half away from zero, exact."""
    v = float(v)
    return float(np.floor(v + 0.5)) if v >= 0 else -float(np.floor(-v + 0.5))


def _polygon_edges(xy):
    """PIL's edge list for a polygon's integer vertices (``ImagingDraw
    Polygon``): one edge a side, the closing side unless the path already
    closes, and a horizontal side that continues the previous horizontal
    side in the same direction merged into it. Rows: (x0, y0, ymin, ymax,
    xmin, xmax, dx)."""
    edges = []

    def add(x0, y0, x1, y1):
        dx = _F32(0.0) if y0 == y1 else _F32(_F32(x1 - x0) / _F32(y1 - y0))
        edges.append([x0, y0, min(y0, y1), max(y0, y1), min(x0, x1),
                      max(x0, x1), dx])

    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            if x1 > x0 > xy[i - 1][0]:
                edges[-1][5] = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1][4] = x1
                continue
        add(x0, y0, x1, y1)
    if xy[-1] != xy[0]:
        add(*xy[-1], *xy[0])
    return edges


def _fill_polygon(canvas: np.ndarray, xy) -> None:
    """Fill one polygon into ``canvas`` as Pillow 12's ``draw_polygon(xy,
    ink, fill=1)`` does (``polygon_generic`` in libImaging/Draw.c, as the
    property tests against Pillow pin it): vertices truncated to integers;
    horizontal sides drawn as spans; on each row the float32 crossings of
    the other sides,
    a side's end row counted twice except on the last row; at a vertex row
    a side that meets an earlier side of the same slope sign at a vertex
    is moved next to the two sides' crossings on the adjacent row ("connect
    discontiguous corners"); then spans from ``ROUND_UP`` of each even
    crossing to ``ROUND_DOWN`` of the next, both ends included."""
    h, w = canvas.shape
    edges = _polygon_edges(xy)
    if not edges:
        return
    spans = []  # (y, x_start, x_end), inclusive
    table = []
    ymin, ymax = h - 1, 0
    for e in edges:
        ymin, ymax = min(ymin, e[2]), max(ymax, e[3])
        if e[2] == e[3]:
            spans.append((e[2], e[4], e[5]))
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if table and ymin <= ymax:
        x0 = np.asarray([e[0] for e in table])
        y0 = np.asarray([e[1] for e in table])
        emin = np.asarray([e[2] for e in table])
        emax = np.asarray([e[3] for e in table])
        dx = np.asarray([e[6] for e in table], _F32)
        rows = np.arange(ymin, ymax + 1)

        def x_at(y, k):
            return _F32(_F32(y - y0[k]) * dx[k]) + _F32(x0[k])

        # (rows, edges) crossings in float32, as the C loop computes them
        xs = (((rows[:, None] - y0[None]).astype(_F32) * dx[None])
              + x0[None].astype(_F32))
        active = (rows[:, None] >= emin) & (rows[:, None] <= emax)
        dup = active & (rows[:, None] == emax) & (rows[:, None] < ymax)
        corner = (active & ~dup & (dx[None] != 0)
                  & ((rows[:, None] == emin) | (rows[:, None] == emax)))
        for r, i in zip(*np.nonzero(corner)):
            y = int(rows[r])
            x = xs[r, i]
            for k in range(i):
                if (dx[i] > 0 and dx[k] <= 0) or (dx[i] < 0 and dx[k] >= 0):
                    continue
                if y not in (emin[k], emax[k]):
                    continue
                if _roundf(x) != _roundf(x_at(y, k)):
                    continue
                off = -1 if y == emax[i] else 1
                if not emin[k] <= y + off <= emax[k]:
                    continue
                adj, adj2 = x_at(y + off, i), x_at(y + off, k)
                if x > adj + _F32(1) and x > adj2 + _F32(1):
                    xs[r, i] = _F32(_roundf(max(adj, adj2)) + 1)
                elif x < adj - _F32(1) and x < adj2 - _F32(1):
                    xs[r, i] = _F32(_roundf(min(adj, adj2)) - 1)
                break
        inf = _F32(np.inf)
        both = np.concatenate([np.where(active, xs, inf),
                               np.where(dup, xs, inf)], axis=1)
        both.sort(axis=1)
        count = active.sum(1) + dup.sum(1)
        lo, hi = both[:, 0::2], both[:, 1::2]
        pair = np.arange(hi.shape[1])[None] * 2 + 1 < count[:, None]
        rr, pp = np.nonzero(pair)
        start = _round_up(lo[rr, pp])
        end = _round_down(hi[rr, pp])
        keep = end >= start
        spans.extend(zip(rows[rr][keep].tolist(), start[keep].tolist(),
                         end[keep].tolist()))
    for y, a, b in spans:  # PIL's hline8: clipped, both ends included
        if 0 <= y < h and a < w and b >= 0:
            canvas[y, max(a, 0):min(b, w - 1) + 1] = 1


def polygons_to_mask(polygons: List[List[float]], h: int, w: int
                     ) -> np.ndarray:
    """Rasterize COCO polygons exactly like the reference pipeline
    (datasets/coco.py:137-143): PIL ImageDraw.polygon(outline=1, fill=1)
    per polygon onto one shared canvas. PIL's boundary-pixel semantics
    differ from cv2.fillPoly; gt-mask parity requires matching them. This
    is PIL's fill in numpy (:func:`_fill_polygon`); polygons of fewer than
    3 points are skipped, as the JAX package skips them."""
    canvas = np.zeros((h, w), np.uint8)
    for p in polygons:
        xy = np.asarray(p, np.float64).reshape(-1, 2)
        if len(xy) < 3:
            continue
        # C's (int) cast of each double coordinate: toward zero
        _fill_polygon(canvas, [(int(x), int(y)) for x, y in xy])
    return canvas


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygon list | uncompressed RLE | compressed RLE)
    -> (h, w) uint8."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    if isinstance(segm, dict):
        return rle_util.decode_rle(segm).astype(np.uint8)
    raise ValueError(f"unsupported segmentation type: {type(segm)}")


class COCOInstanceSegmentationDataset:
    """Examples: (img (H, W, 3) RGB uint8, bboxes (R, 4) float32 y1x1y2x2,
    labels (R,) int32 0-based fg, masks (R, H, W) int32
    [, crowds (R,), areas (R,)])."""

    # url + md5 of the archive (md5s from the reference download table,
    # chainer_mask_rcnn/datasets/coco.py:24-50; the image zips are
    # unchecksummed there too).
    DOWNLOAD_URLS = {
        "train2014": (
            "http://images.cocodataset.org/zips/train2014.zip", None,
        ),
        "val2014": (
            "http://images.cocodataset.org/zips/val2014.zip", None,
        ),
        "instances_train-val2014.zip": (
            "http://msvocds.blob.core.windows.net/annotations-1-0-3/"
            "instances_train-val2014.zip",
            "59582776b8dd745d649cd249ada5acf7",
        ),
        "annotations/instances_minival2014.json.zip": (
            "https://dl.dropboxusercontent.com/s/o43o90bna78omob/"
            "instances_minival2014.json.zip",
            "395a089042d356d97017bf416e4e99fb",
        ),
        "annotations/instances_valminusminival2014.json.zip": (
            "https://dl.dropboxusercontent.com/s/s3tw5zcg7395368/"
            "instances_valminusminival2014.json.zip",
            "f72ed643338e184978e8228948972e84",
        ),
    }

    def __init__(
        self,
        split: str = "train",
        year: str = "2014",
        root: str = "~/data/datasets/COCO",
        use_crowd: bool = False,
        return_crowd: bool = False,
        return_area: bool = False,
    ):
        if split not in ("train", "val", "minival", "valminusminival"):
            raise ValueError(f"unsupported split: {split}")
        self.root = osp.expanduser(root)
        self.split = split
        self.year = year
        self.use_crowd = use_crowd
        self.return_crowd = return_crowd
        self.return_area = return_area

        img_split = "train" if split == "train" else "val"
        self.img_dir = osp.join(self.root, f"{img_split}{year}")
        ann_file = osp.join(
            self.root, "annotations", f"instances_{split}{year}.json"
        )
        if not osp.exists(ann_file):
            raise FileNotFoundError(
                f"{ann_file} not found; DOWNLOAD_URLS names the sources"
            )
        with open(ann_file) as f:
            coco = json.load(f)

        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.class_names = tuple(c["name"] for c in cats)
        self.cat_id_to_class_id: Dict[int, int] = {
            c["id"]: i for i, c in enumerate(cats)
        }

        self.images = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict[int, list] = {}
        for ann in coco["annotations"]:
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        # Filter images without (non-crowd, unless use_crowd) annotations —
        # reference coco.py:94-100.
        self.img_ids = [
            iid
            for iid in sorted(self.images)
            if any(
                self.use_crowd or not a.get("iscrowd", 0)
                for a in anns_by_img.get(iid, [])
            )
        ]
        self.anns_by_img = anns_by_img

    def __len__(self):
        return len(self.img_ids)

    def image_sizes(self):
        """(H, W) per example without decoding images (from the json) —
        enables aspect-ratio grouping in the train loader."""
        return [
            (self.images[i]["height"], self.images[i]["width"])
            for i in self.img_ids
        ]

    def download(self):
        """Nothing is fetched: print the sources, and md5-verify any
        archive already under the root (reference behavior:
        cached_download with md5, datasets/coco.py:24-50)."""
        from mask_rcnn_tpu_torch.data._download import (
            print_sources_and_verify,
        )

        print_sources_and_verify(
            self.root,
            [(name, url, md5)
             for name, (url, md5) in self.DOWNLOAD_URLS.items()],
        )

    def get_example(self, i: int):
        img_id = self.img_ids[i]
        info = self.images[img_id]
        img = read_rgb(osp.join(self.img_dir, info["file_name"]))
        h, w = img.shape[:2]

        bboxes, labels, masks, crowds, areas = [], [], [], [], []
        for ann in self.anns_by_img.get(img_id, []):
            iscrowd = int(ann.get("iscrowd", 0))
            if iscrowd and not self.use_crowd:
                continue
            mask = segmentation_to_mask(ann["segmentation"], h, w)
            if mask.sum() == 0:
                continue
            bboxes.append(mask_to_bbox(mask))
            labels.append(self.cat_id_to_class_id[ann["category_id"]])
            masks.append(mask.astype(np.int32))
            crowds.append(iscrowd)
            areas.append(float(ann.get("area", mask.sum())))

        bboxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int32)
        masks = np.asarray(masks, np.int32).reshape((-1, h, w))
        out = [img, bboxes, labels, masks]
        if self.return_crowd:
            out.append(np.asarray(crowds, np.int32))
        if self.return_area:
            out.append(np.asarray(areas, np.float32))
        return tuple(out)

    __getitem__ = get_example
