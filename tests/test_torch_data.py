"""The port's data path (``data/transforms.py``, ``data/loader.py``) and RLE
codec (``utils/rle.py``) against the JAX package's, on the same seeded
examples and the same ``RandomState`` draws.

cv2's optimized (IPP) bilinear resize differs from its plain path by up to
6.6e-3 on 0-255 data; the port reproduces the plain path, so the JAX side
runs with ``cv2.setUseOptimized(False)`` and images agree to 1.5e-5 (one
float32 ulp at 128-255; 0 at these tests' sizes, 1.53e-5 at 480x640 ->
800x1067): the tolerance is two such ulps."""

import warnings

import cv2
import numpy as np
import pytest

from mask_rcnn_tpu.data import loader as jax_loader
from mask_rcnn_tpu.data import transforms as jax_transforms
from mask_rcnn_tpu.utils import rle as jax_rle
from mask_rcnn_tpu_torch.data import loader, transforms
from mask_rcnn_tpu_torch.utils import rle

MEAN = (123.152, 115.903, 103.063)
IMAGE_ATOL = 2.0 ** -15  # two float32 ulps at 128-255
# The JAX loader transforms in its prefetch thread, where cv2 runs its
# optimized (IPP) resize whatever setUseOptimized said in the main thread
# (the flag is per thread): IPP's seam, up to 6.6e-3 of 0-255 data.
LOADER_IMAGE_ATOL = 6.6e-3


@pytest.fixture(autouse=True)
def plain_cv2():
    was = cv2.useOptimized()
    cv2.setUseOptimized(False)
    yield
    cv2.setUseOptimized(was)


def example(rng, h, w, g=3):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    masks = np.zeros((g, h, w), np.int32)
    boxes = []
    for k in range(g):
        y1, x1 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        y2, x2 = y1 + rng.randint(3, h // 2), x1 + rng.randint(3, w // 2)
        masks[k, y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.3
        boxes.append((y1, x1, y2, x2))
    return (img, np.asarray(boxes, np.float32),
            rng.randint(0, 5, g).astype(np.int32), masks)


class Dataset:
    def __init__(self, shapes, seed=0, sizes=False):
        rng = np.random.RandomState(seed)
        self.examples = [example(rng, h, w) for h, w in shapes]
        if sizes:
            self.image_sizes = lambda: [e[0].shape[:2] for e in self.examples]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        return self.examples[i]


def assert_examples_equal(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=IMAGE_ATOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hw,sizes", [
    ((37, 53), (64, 96)),    # upscale, capped by max_size
    ((120, 90), (64, 96)),   # portrait downscale
    ((61, 61), (48, 200)),   # short side rules
])
def test_train_transform_matches_jax(hw, sizes):
    e = example(np.random.RandomState(1), *hw)
    mine = transforms.MaskRCNNTransform(*sizes, MEAN, train=True,
                                        rng=np.random.RandomState(5))
    theirs = jax_transforms.MaskRCNNTransform(*sizes, MEAN, train=True,
                                              rng=np.random.RandomState(5))
    for _ in range(4):  # the same flip draws, in order
        assert_examples_equal(mine(e), theirs(e))


def test_eval_transform_matches_jax():
    e = example(np.random.RandomState(2), 40, 50)
    mine = transforms.MaskRCNNTransform(64, 96, MEAN, train=False)
    theirs = jax_transforms.MaskRCNNTransform(64, 96, MEAN, train=False)
    assert_examples_equal(mine(e), theirs(e))


@pytest.mark.parametrize("src,dst", [(37, 64), (120, 51), (100, 100),
                                     (7, 96), (333, 48)])
def test_nearest_index_matches_cv2(src, dst):
    col = np.arange(src, dtype=np.uint16)[None, :].repeat(2, 0)
    want = cv2.resize(col, (dst, 2), interpolation=cv2.INTER_NEAREST)[0]
    np.testing.assert_array_equal(transforms.nearest_index(src, dst), want)


def test_pad_batch_matches_jax():
    rng = np.random.RandomState(3)
    t = jax_transforms.MaskRCNNTransform(64, 96, MEAN, train=False)
    exs = [t(example(rng, h, w)) for h, w in ((60, 90), (64, 80), (50, 96))]
    for kw in ({}, {"pack_masks": False},
               {"force_shape": (64, 128), "image_fill": (1, 2, 3)}):
        want = jax_loader.pad_batch(exs, 2, 64, 96, **kw)
        got = loader.pad_batch(exs, 2, 64, 96, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


SHAPES = [(40, 60), (60, 40), (50, 70), (48, 48), (70, 45), (44, 66),
          (66, 44), (52, 64), (64, 52)]


def loaders(sizes, train=True, **kw):
    """The port's and the JAX package's loaders on one dataset; without
    ``image_sizes`` both warn that aspect grouping is off."""
    ds = Dataset(SHAPES, sizes=sizes)
    make = dict(batch_size=2, max_boxes=4, min_size=48, max_size=80, seed=3,
                **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mine = loader.TrainLoader(ds, transforms.MaskRCNNTransform(
            48, 80, MEAN, train, np.random.RandomState(0)), **make)
        theirs = jax_loader.TrainLoader(ds, jax_transforms.MaskRCNNTransform(
            48, 80, MEAN, train, np.random.RandomState(0)), **make)
    assert len(caught) == (0 if sizes else 2)
    return mine, theirs


@pytest.mark.parametrize("sizes", [False, True])
def test_train_loader_matches_jax_over_three_epochs(sizes):
    mine, theirs = loaders(sizes)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch()
    for epoch in range(3):
        np.testing.assert_array_equal(mine.epoch_indices(epoch),
                                      theirs.epoch_indices(epoch))
        assert mine.batches_in_epoch(epoch) == theirs.batches_in_epoch(epoch)
        got, want = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            np.testing.assert_allclose(g["image"], w["image"], rtol=0,
                                       atol=LOADER_IMAGE_ATOL)
            for k in ("bbox", "label", "bbox_valid", "mask", "scale"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("sizes", [False, True])
def test_resume_position_and_skip_match_jax(sizes):
    """``position_for_step`` and ``epoch(skip=k)`` give the JAX loader's
    positions, and a skipped epoch yields the tail of the full one (with the
    eval transform: the train transform's flips come from a generator whose
    draws follow the examples it has seen, in both packages)."""
    mine, theirs = loaders(sizes, process_index=1, process_count=2)
    n = mine.steps_per_epoch()
    for step in range(3 * n + 1):
        assert mine.position_for_step(step) == theirs.position_for_step(step)
    mine, theirs = loaders(sizes, train=False)
    full = list(mine.epoch(1))
    tail, want = list(mine.epoch(1, skip=1)), list(theirs.epoch(1, skip=1))
    assert len(tail) == len(want) == len(full) - 1
    for g, w, f in zip(tail, want, full[1:]):
        np.testing.assert_array_equal(g["bbox"], f["bbox"])
        np.testing.assert_array_equal(g["mask"], w["mask"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_strings_match_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 60, 2)
    mask = rng.rand(h, w) > rng.uniform(0.1, 0.9)
    if seed == 1:
        mask[0, 0] = True  # a mask starting with a one-run
    want = jax_rle.encode_mask(mask)
    got = rle.encode_mask(mask)
    assert got == want  # byte-identical counts string, same size
    np.testing.assert_array_equal(rle.decode_rle(got), mask)
    assert rle.rle_area(got) == jax_rle.rle_area(want) == int(mask.sum())


def test_rle_iou_matches_jax():
    rng = np.random.RandomState(4)
    dets = [rle.encode_mask(rng.rand(20, 30) > 0.5) for _ in range(3)]
    gts = [rle.encode_mask(rng.rand(20, 30) > 0.4) for _ in range(2)]
    crowd = [False, True]
    np.testing.assert_array_equal(rle.rle_iou(dets, gts, crowd),
                                  jax_rle.rle_iou(dets, gts, crowd))
