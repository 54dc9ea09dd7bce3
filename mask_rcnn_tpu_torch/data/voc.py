"""VOC2012 / SBD / VOC-like instance segmentation datasets, the port of
``mask_rcnn_tpu/data/voc.py`` without cv2 or PIL.

Capability parity with reference datasets/voc/voc.py, datasets/voc/sbd.py and
examples/custom_dataset (VOCLikeDataset): examples are
``(img (H, W, 3) RGB uint8, bboxes (R, 4) f32, labels (R,) i32 0-based fg,
masks (R, H, W) i32)``. Images are read by ``data/_image.py::read_rgb``
(JPEG needs cv2 or PIL), label PNGs by its PNG decoder, image sizes from
the file headers, SBD's ``.mat`` files by a lazily imported ``scipy.io``.
Nothing is downloaded: ``DOWNLOAD_ARCHIVES`` only names the archives.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from mask_rcnn_tpu_torch.data._image import image_size, read_png, read_rgb
from mask_rcnn_tpu_torch.utils.geometry import label2instance_boxes

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _read_label_png(path: str) -> np.ndarray:
    """Palette (or gray) PNG -> int32 label image; 255 -> -1 (VOC
    ignore)."""
    lbl = read_png(path).astype(np.int32)
    lbl[lbl == 255] = -1
    return lbl


def _image_sizes_from_headers(paths):
    """(H, W) per image from the JPEG/PNG headers, without decoding pixels:
    cheap enough for the train loader's one-time aspect-grouping probe even
    on the 5.6k-image SBD split."""
    return [image_size(p) for p in paths]


def _example_from_labels(img, lbl_cls, lbl_ins):
    labels, bboxes, masks = label2instance_boxes(lbl_ins, lbl_cls)
    return (
        img,
        bboxes.astype(np.float32),
        (labels - 1).astype(np.int32),  # 0-based fg classes
        masks.astype(np.int32),
    )


class VOC2012InstanceSegmentationDataset:
    """VOC2012 SegmentationClass/SegmentationObject pairs
    (reference datasets/voc/voc.py:13-129)."""

    class_names = VOC_CLASS_NAMES

    DOWNLOAD_ARCHIVES = (
        (
            "VOCtrainval_11-May-2012.tar",
            "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
            "VOCtrainval_11-May-2012.tar",
            "6cd6e144f989b92b3379bac3b3de84fd",
        ),
    )

    def __init__(self, split: str = "train",
                 root: str = "~/data/datasets/VOC/VOCdevkit/VOC2012"):
        if split not in ("train", "val"):
            raise ValueError(split)
        self.root = osp.expanduser(root)
        split_file = osp.join(
            self.root, "ImageSets/Segmentation", f"{split}.txt"
        )
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.ids)

    def get_example(self, i: int):
        did = self.ids[i]
        img_path = osp.join(self.root, "JPEGImages", did + ".jpg")
        cls_path = osp.join(self.root, "SegmentationClass", did + ".png")
        ins_path = osp.join(self.root, "SegmentationObject", did + ".png")
        img = read_rgb(img_path)
        lbl_cls = _read_label_png(cls_path)
        lbl_ins = _read_label_png(ins_path)
        return _example_from_labels(img, lbl_cls, lbl_ins)

    __getitem__ = get_example

    def image_sizes(self):
        """(H, W) per example from image headers (no pixel decode) —
        enables aspect-ratio grouping in the train loader."""
        return _image_sizes_from_headers(
            osp.join(self.root, "JPEGImages", did + ".jpg")
            for did in self.ids
        )


class SBDInstanceSegmentationDataset:
    """SBD (benchmark_RELEASE) .mat GTcls/GTinst loader
    (reference datasets/voc/sbd.py:16-70).

    Defaults to the FCIS 5623/5732 train/val id lists the reference vendors
    (datasets/voc/data/VOCdevkit/VOCSDS/ImageSets/Main/{train,val}.txt) —
    the published VOC numbers (examples/voc/README.md:20-24) are computed on
    these splits, not SBD's own larger ``train.txt``. Pass ``split_file`` to
    override.
    """

    class_names = VOC_CLASS_NAMES

    DOWNLOAD_ARCHIVES = (
        (
            "benchmark.tgz",
            "http://www.eecs.berkeley.edu/Research/Projects/CS/vision/"
            "grouping/semantic_contours/benchmark.tgz",
            "82b4d87ceb2ed10f6038a1cba92111cb",
        ),
    )

    def __init__(self, split: str = "train",
                 root: str = "~/data/datasets/VOC/benchmark_RELEASE/dataset",
                 split_file: str | None = None):
        if split not in ("train", "val") and split_file is None:
            raise ValueError(split)
        self.root = osp.expanduser(root)
        if split_file is None:
            # A root carrying its own SDS-layout split lists (the layout
            # the reference vendors its FCIS lists in,
            # VOCdevkit/VOCSDS/ImageSets/Main/*.txt) wins — this is how a
            # synthetic rehearsal root or a custom re-split drives the
            # unmodified drivers. The stock benchmark_RELEASE download has
            # no ImageSets/ directory, so real SBD roots still get the
            # vendored FCIS 5623/5732 lists the published numbers use.
            root_local = osp.join(
                self.root, "ImageSets", "Main", f"{split}.txt"
            )
            split_file = root_local if osp.exists(root_local) else osp.join(
                osp.dirname(__file__), "sbd_splits", f"{split}.txt"
            )
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.ids)

    def get_example(self, i: int):
        import scipy.io

        did = self.ids[i]
        img_path = osp.join(self.root, "img", did + ".jpg")
        img = read_rgb(img_path)
        cls_mat = scipy.io.loadmat(
            osp.join(self.root, "cls", did + ".mat")
        )
        ins_mat = scipy.io.loadmat(
            osp.join(self.root, "inst", did + ".mat")
        )
        lbl_cls = cls_mat["GTcls"][0][0]["Segmentation"].astype(np.int32)
        lbl_ins = ins_mat["GTinst"][0][0]["Segmentation"].astype(np.int32)
        # reference sbd.py:47-53: 255 -> -1 ignore in both label images,
        # and instances are voided wherever the class image says
        # background/ignore
        lbl_cls[lbl_cls == 255] = -1
        lbl_ins[lbl_ins == 255] = -1
        lbl_ins[np.isin(lbl_cls, (-1, 0))] = -1
        return _example_from_labels(img, lbl_cls, lbl_ins)

    __getitem__ = get_example

    def image_sizes(self):
        """(H, W) per example from JPEG headers (no pixel decode)."""
        return _image_sizes_from_headers(
            osp.join(self.root, "img", did + ".jpg") for did in self.ids
        )


class VOCLikeDataset:
    """Bring-your-own-dataset contract (reference
    examples/custom_dataset/train.py:19-87): a directory of images + npy
    class/instance label images."""

    def __init__(self, img_paths, cls_paths, ins_paths, class_names):
        assert len(img_paths) == len(cls_paths) == len(ins_paths)
        self.img_paths = list(img_paths)
        self.cls_paths = list(cls_paths)
        self.ins_paths = list(ins_paths)
        self.class_names = tuple(class_names)

    def __len__(self):
        return len(self.img_paths)

    def get_example(self, i: int):
        img = read_rgb(self.img_paths[i])
        lbl_cls = np.load(self.cls_paths[i]).astype(np.int32)
        lbl_ins = np.load(self.ins_paths[i]).astype(np.int32)
        return _example_from_labels(img, lbl_cls, lbl_ins)

    def image_sizes(self):
        """(H, W) per example from image headers (no pixel decode)."""
        return _image_sizes_from_headers(self.img_paths)

    __getitem__ = get_example


class IndexingDataset:
    """Subset view by indices (reference datasets/indexing_dataset.py)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def get_example(self, i):
        return self.dataset[self.indices[i]]

    __getitem__ = get_example

    @property
    def return_crowd(self):
        # forwarded so evaluators can tell what the example tuple holds
        return getattr(self.dataset, "return_crowd", None)

    @property
    def return_area(self):
        return getattr(self.dataset, "return_area", None)

    def image_sizes(self):
        """Subset view of the wrapped dataset's size metadata (keeps
        aspect-ratio grouping working through the subset)."""
        fn = getattr(self.dataset, "image_sizes", None)
        if fn is None:
            raise AttributeError(
                f"{type(self.dataset).__name__} does not expose image_sizes"
            )
        sizes = fn() if callable(fn) else fn
        return [sizes[i] for i in self.indices]
