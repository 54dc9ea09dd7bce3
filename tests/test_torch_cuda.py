"""The hand-written CUDA kernels against their plain torch versions, edge
cases included. These need a CUDA device (marker ``cuda``) and skip
without one; run them on the GPU with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mask_rcnn_tpu_torch.ops import nms, roi_align
from tests.oracles import random_boxes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0),
                                                       (2, 2), (1, 3)])
def test_roi_align_kernel_matches_plain(dev, dtype, bin_stride,
                                        sampling_ratio):
    rng = np.random.RandomState(0)
    n, h, w, c = 2, 13, 21, 70  # c not a multiple of the thread tile
    feats = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    rois = np.stack([random_boxes(rng, 37, h * 16, w * 16, min_size=2)
                     for _ in range(n)])
    rois[:, :4] = [[-20, -20, 40, 40], [h * 16 - 30, w * 16 - 30,
                                        h * 16 + 30, w * 16 + 30],
                   [0, 0, 4, 4], [0, 0, 0, 0]]
    rois = torch.from_numpy(rois)
    f = feats.to(dev, dtype)
    got = roi_align.roi_align_grouped(f, rois.to(dev), 7, 1 / 16,
                                      sampling_ratio, bin_stride)
    want = roi_align.roi_align_grouped_plain(f.float(), rois.to(dev), 7,
                                             1 / 16, sampling_ratio,
                                             bin_stride)
    assert got.dtype == dtype
    # float32: summation order; bf16: one rounding of the float32 result
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("b,n,max_out", [(2, 12000, 2000), (1, 6000, 1000),
                                         (3, 1500, 300), (2, 100, 150),
                                         (1, 1, 5)])
def test_nms_blocked_kernel_matches_plain(dev, b, n, max_out):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(np.stack(
        [random_boxes(rng, n, 300, 400, min_size=4) for _ in range(b)]))
    valid = torch.from_numpy(rng.rand(b, n) > 0.1)
    got = nms.nms_blocked(boxes.to(dev), valid.to(dev), 0.7, max_out)
    want = nms.nms_blocked_plain(boxes, valid, 0.7, max_out)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("b,n,max_out", [(80, 256, 100), (4, 1024, 300),
                                         (3, 70, 100), (2, 1, 3)])
def test_nms_small_kernel_matches_plain(dev, b, n, max_out):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(np.stack(
        [random_boxes(rng, n, 100, 120, min_size=4) for _ in range(b)]))
    valid = torch.from_numpy(rng.rand(b, n) > 0.1)
    valid[0] = False  # a problem with nothing valid
    got = nms.nms_small(boxes.to(dev), valid.to(dev), 0.5, max_out)
    want = nms.nms_small_plain(boxes, valid, 0.5, max_out)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    feats = torch.zeros((1, 4, 4, 8), device=dev)
    rois = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError):
        roi_align.roi_align_grouped(feats.half(), rois, 7, 1 / 16)
    with pytest.raises(ValueError):
        roi_align.roi_align_grouped(feats, rois.double(), 7, 1 / 16)
    with pytest.raises(ValueError):
        roi_align.roi_align_grouped(feats.transpose(1, 2), rois, 7, 1 / 16)
    boxes = torch.zeros((1, 5, 4), device=dev)
    with pytest.raises(ValueError):
        nms.nms_small(boxes, torch.ones((1, 4), dtype=torch.bool,
                                        device=dev), 0.5, 3)
    with pytest.raises(ValueError):
        nms.nms_small(torch.zeros((1, 2000, 4), device=dev),
                      torch.ones((1, 2000), dtype=torch.bool, device=dev),
                      0.5, 3)


def border_rois(rng, n, r, h, w):
    """Per-image rois in image coordinates (feature stride 16), the first
    ones on and beyond the borders, one zero-padded slot."""
    rois = np.stack([random_boxes(rng, r, h * 16, w * 16, min_size=2)
                     for _ in range(n)])
    rois[:, :4] = [[-20, -20, 40, 40], [h * 16 - 30, w * 16 - 30,
                                        h * 16 + 30, w * 16 + 30],
                   [0, 0, h * 16, w * 16], [0, 0, 0, 0]]
    return torch.from_numpy(rois)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0),
                                                       (2, 2)])
def test_roi_align_backward_kernel_matches_plain(dev, dtype, bin_stride,
                                                 sampling_ratio):
    rng = np.random.RandomState(1)
    n, h, w, c, r = 2, 13, 21, 70, 37
    rois = border_rois(rng, n, r, h, w).to(dev)
    g = torch.from_numpy(rng.randn(n, r, 7, 7, c).astype(np.float32))
    g = g.to(dev, dtype)
    args = ((h, w), 1 / 16, sampling_ratio, bin_stride)
    got = roi_align.roi_align_grouped_backward(g, rois, *args)
    want = roi_align.roi_align_grouped_backward_plain(g.float(), rois, *args)
    assert got.dtype == dtype and got.is_contiguous()
    assert got.shape == (n, h, w, c)
    # float32: the atomics' order; bf16: one rounding of the float32 sum
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())


def test_roi_align_autograd_runs_both_kernels(dev):
    rng = np.random.RandomState(2)
    n, h, w, c = 2, 9, 11, 64
    feats = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    rois = border_rois(rng, n, 20, h, w)
    g = torch.from_numpy(rng.randn(n, 20, 7, 7, c).astype(np.float32))
    f = feats.to(dev).requires_grad_(True)
    before = (roi_align.roi_align_grouped.launches,
              roi_align.roi_align_grouped_backward.launches)
    out = roi_align.roi_align_grouped(f, rois.to(dev), 7, 1 / 16, 0, 2)
    out.backward(g.to(dev))
    assert (roi_align.roi_align_grouped.launches,
            roi_align.roi_align_grouped_backward.launches) == (
                before[0] + 1, before[1] + 1)
    fc = feats.clone().requires_grad_(True)
    roi_align.roi_align_grouped(fc, rois, 7, 1 / 16, 0, 2).backward(g)
    torch.testing.assert_close(f.grad.cpu(), fc.grad, rtol=1e-5, atol=1e-5)


def tie_masks(rng, n, g, h, w):
    """Rectangles with edges on even rows/columns: a 28-pixel crop sampled
    at 14 lands exactly midway between two mask rows (interp == 0.5)."""
    m = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1 = 2 * rng.randint(0, h // 4), 2 * rng.randint(0, w // 4)
            m[i, k, y1:y1 + 2 * rng.randint(3, 12),
              x1:x1 + 2 * rng.randint(3, 12)] = 1
            m[i, k] ^= (rng.rand(h, w) < 0.05).astype(np.uint8)
    return m


@pytest.mark.parametrize("packed", [True, False])
def test_mask_crop_resize_kernel_matches_plain(dev, packed):
    from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
    from mask_rcnn_tpu_torch.ops import targets

    rng = np.random.RandomState(3)
    n, g, h, w, q = 2, 5, 64, 96, 40
    masks = tie_masks(rng, n, g, h, w)
    rois = np.stack([random_boxes(rng, q, h, w, min_size=1)
                     for _ in range(n)])
    # crops of 28 and 14 pixels at even and odd offsets: exact ties
    rois[:, :8] = [[0, 0, 28, 28], [2, 4, 30, 32], [1, 3, 29, 17],
                   [10.5, 11.5, 38.5, 25.5], [0, 0, h, w], [5, 5, 5, 5],
                   [h - 3, w - 3, h, w], [3.5, 2.5, 31.5, 30.5]]
    gt_index = rng.randint(0, g, (n, q)).astype(np.int64)
    m = pack_mask_bits(masks) if packed else masks
    args = [torch.from_numpy(a) for a in (m, gt_index, rois)]
    got = targets.mask_crop_resize(*(a.to(dev) for a in args), 14, packed)
    want = targets.mask_crop_resize_plain(*args, 14, packed)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_match_kernels_match_plain(dev):
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, \
        make_anchors
    from mask_rcnn_tpu_torch.ops import targets

    rng = np.random.RandomState(4)
    cfg = MaskRCNNConfig(n_fg_class=3, anchor_scales=(2, 4, 8, 16, 32))
    h, w = 320, 480
    anchors = torch.from_numpy(make_anchors(cfg, h // 16, w // 16))
    n, g = 3, 8
    bbox = np.stack([random_boxes(rng, g, h, w, min_size=8)
                     for _ in range(n)])
    # ties: a duplicated gt, and a gt equal to an anchor
    bbox[0, 1] = bbox[0, 0]
    bbox[0, 2] = anchors[1000].numpy()
    valid = np.ones((n, g), bool)
    valid[1, 5:] = False
    valid[2] = False  # no valid gt
    bbox, valid = torch.from_numpy(bbox), torch.from_numpy(valid)
    got = targets.anchor_match(anchors.to(dev), bbox.to(dev), valid.to(dev),
                               (h, w), 0.7, 0.3)
    want = targets.anchor_match_plain(anchors, bbox, valid, (h, w), 0.7, 0.3)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert (want[1][0] == 1).any()

    cand = np.stack([np.concatenate([random_boxes(rng, 300, h, w),
                                     bbox[i].numpy()]) for i in range(n)])
    cand = torch.from_numpy(cand)
    cvalid = torch.from_numpy(rng.rand(n, 308) > 0.1)
    got = targets.proposal_match(cand.to(dev), cvalid.to(dev), bbox.to(dev),
                                 valid.to(dev), 0.5, 0.5, 0.0)
    want = targets.proposal_match_plain(cand, cvalid, bbox, valid, 0.5, 0.5,
                                        0.0)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert want[2][2].any() and not want[1][2].any()  # zero-gt background


def test_target_wrappers_reject_what_the_kernels_do_not_take(dev):
    from mask_rcnn_tpu_torch.ops import targets

    anchors = torch.zeros((10, 4), device=dev)
    bbox = torch.zeros((1, 3, 4), device=dev)
    valid = torch.ones((1, 3), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # float64 anchors
        targets.anchor_match(anchors.double(), bbox, valid, (8, 8), .7, .3)
    with pytest.raises(ValueError):  # no gt slot
        targets.anchor_match(anchors, bbox[:, :0], valid[:, :0], (8, 8),
                             .7, .3)
    with pytest.raises(ValueError):  # validity as uint8
        targets.proposal_match(anchors[None],
                               torch.ones((1, 10), dtype=torch.bool,
                                          device=dev),
                               bbox, valid.byte(), .5, .5, 0.)
    masks = torch.zeros((1, 3, 8, 1), dtype=torch.uint8, device=dev)
    idx = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    rois = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError):  # int32 gt index
        targets.mask_crop_resize(masks, idx.int(), rois, 14, True)
    with pytest.raises(ValueError):  # non-contiguous rois
        targets.mask_crop_resize(masks, idx, rois.transpose(0, 1), 14, True)
    with pytest.raises(ValueError):  # unsupported grad dtype
        roi_align.roi_align_grouped_backward(
            torch.zeros((1, 2, 7, 7, 8), dtype=torch.float16, device=dev),
            rois, (4, 4), 1 / 16)


def flat_edge_rois(rng, n, h, w, r):
    """Flat rois (feature stride 16) with image indices: half-integer scaled
    ends (round half to even), extents near multiples of 7, crops of one
    cell, rois past the borders, a zero slot, then random boxes."""
    fixed = np.array([
        [40, 56, 120, 152], [8, 24, 72, 88], [0, 0, 80, 96],
        [16, 16, 112, 112], [0, 16, 112, 128], [0, 0, 192, 16],
        [32, 32, 32, 32], [50, 60, 52, 61], [-40, -30, 60, 80],
        [h * 16 - 40, w * 16 - 50, h * 16 + 60, w * 16 + 70],
        [-10, -10, h * 16 + 100, w * 16 + 100], [0, 0, 0, 0],
    ], np.float32)
    rois = np.concatenate([fixed, random_boxes(rng, r - len(fixed), h * 16,
                                               w * 16, min_size=2)])
    idx = rng.randint(0, n, r).astype(np.int32)
    return torch.from_numpy(rois), torch.from_numpy(idx)


def tie_features(rng, n, h, w, c):
    """Relu'd values on a coarse grid, with a block of exact zeros: the max
    ties often, as on relu'd res4 features."""
    f = np.maximum(rng.randint(-3, 4, (n, h, w, c)), 0).astype(np.float32)
    f[0, 2:8, 3:12] = 0.0
    return torch.from_numpy(f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [14, 7])
def test_crop_and_resize_kernels_match_plain(dev, dtype, out_size):
    rng = np.random.RandomState(5)
    n, h, w, c, r = 2, 13, 21, 70, 45  # c not a multiple of the thread tile
    feats = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    rois, idx = flat_edge_rois(rng, n, h, w, r)
    f, rd, i = feats.to(dev, dtype), rois.to(dev), idx.to(dev)
    got = roi_align.crop_and_resize(f, rd, i, out_size, 1 / 16)
    want = roi_align.crop_and_resize_plain(f.float(), rd, i, out_size, 1 / 16)
    assert got.dtype == dtype
    # float32: summation order; bf16: one rounding of the float32 result
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)

    g = torch.from_numpy(rng.randn(r, out_size, out_size, c).astype(
        np.float32)).to(dev, dtype)
    got = roi_align.crop_and_resize_backward(g, rd, i, (n, h, w), 1 / 16)
    want = roi_align.crop_and_resize_backward_plain(g.float(), rd, i,
                                                    (n, h, w), 1 / 16)
    assert got.dtype == dtype and got.is_contiguous()
    assert got.shape == (n, h, w, c)
    # float32: the atomics' order; bf16: one rounding of the float32 sum
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [14, 7, 2])
def test_roi_pool_kernels_match_plain(dev, dtype, out_size):
    rng = np.random.RandomState(6)
    n, h, w, c, r = 2, 13, 21, 70, 45
    feats = tie_features(rng, n, h, w, c)
    feats[1] = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    rois, idx = flat_edge_rois(rng, n, h, w, r)
    f, rd, i = feats.to(dev, dtype), rois.to(dev), idx.to(dev)
    got = roi_align.roi_pool(f, rd, i, out_size, 1 / 16)
    want = roi_align.roi_pool_plain(f, rd, i, out_size, 1 / 16)
    assert got.dtype == dtype
    assert torch.equal(got, want)  # the max is exact
    assert (want == 0).any()  # empty bins and zero maxima

    # an integer cotangent: tie weights are powers of two, every sum exact
    g = torch.from_numpy(rng.randint(-4, 5, (r, out_size, out_size, c)))
    g = g.to(dev, dtype)
    got = roi_align.roi_pool_backward(g, f, rd, i, 1 / 16)
    want = roi_align.roi_pool_backward_plain(g, f, rd, i, 1 / 16)
    assert got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        assert torch.equal(got, want)
    # a random cotangent: the atomics' order, and one bf16 rounding
    g = torch.from_numpy(rng.randn(r, out_size, out_size, c).astype(
        np.float32)).to(dev, dtype)
    got = roi_align.roi_pool_backward(g, f, rd, i, 1 / 16)
    want = roi_align.roi_pool_backward_plain(g.float(), f.float(), rd, i,
                                             1 / 16)
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())


def test_roi_pool_backward_kernel_splits_ties(dev):
    """An all-zero map: every position of a bin ties, and the weights are
    jax.grad's halving chain (tests/test_torch_pooling.py)."""
    feats = torch.zeros((1, 8, 8, 40))
    rois = torch.tensor([[0.0, 0.0, 63.0, 63.0]])
    idx = torch.zeros(1, dtype=torch.int32)
    g = torch.ones((1, 2, 2, 40))
    want = roi_align.roi_pool_backward_plain(g, feats, rois, idx, 1 / 16)
    got = roi_align.roi_pool_backward(g.to(dev), feats.to(dev), rois.to(dev),
                                      idx.to(dev), 1 / 16)
    assert torch.equal(got.cpu(), want)
    assert want[0, 2, 2, 0] == 9 / 16 and want[0, 0, 0, 0] == 1 / 16


@pytest.mark.parametrize("fn,fwd,bwd", [
    ("crop_and_resize", "crop_and_resize", "crop_and_resize_backward"),
    ("roi_pool", "roi_pool", "roi_pool_backward")])
def test_pool_autograd_runs_both_kernels(dev, fn, fwd, bwd):
    rng = np.random.RandomState(7)
    n, h, w, c, r = 2, 9, 11, 64, 20
    feats = tie_features(rng, n, h, w, c)
    rois, idx = flat_edge_rois(rng, n, h, w, r)
    g = torch.from_numpy(rng.randn(r, 14, 14, c).astype(np.float32))
    pool = getattr(roi_align, fn)
    counters = (getattr(roi_align, fwd), getattr(roi_align, bwd))
    before = [k.launches for k in counters]
    f = feats.to(dev).requires_grad_(True)
    pool(f, rois.to(dev), idx.to(dev), 14, 1 / 16).backward(g.to(dev))
    assert [k.launches for k in counters] == [b + 1 for b in before]
    fc = feats.clone().requires_grad_(True)
    pool(fc, rois, idx, 14, 1 / 16).backward(g)
    torch.testing.assert_close(f.grad.cpu(), fc.grad, rtol=1e-5,
                               atol=1e-5 * fc.grad.abs().max().item())


@pytest.mark.parametrize("fn", ["crop_and_resize", "roi_pool"])
def test_pool_wrappers_reject_what_the_kernels_do_not_take(dev, fn):
    pool = getattr(roi_align, fn)
    feats = torch.zeros((2, 4, 4, 8), device=dev)
    rois = torch.zeros((3, 4), device=dev)
    idx = torch.zeros(3, dtype=torch.int32, device=dev)
    for bad in (
        (feats.half(), rois, idx),  # float16 features
        (feats.transpose(1, 2), rois, idx),  # not contiguous NHWC
        (feats, rois.double(), idx),  # float64 rois
        (feats, rois[None], idx),  # grouped rois
        (feats, rois, idx.long()),  # int64 indices
        (feats, rois, idx[:2]),  # one index short
        (feats, rois.cpu(), idx),  # rois on another device
    ):
        with pytest.raises(ValueError):
            pool(*bad, 14, 1 / 16)
    g = torch.zeros((3, 14, 14, 8), device=dev)
    with pytest.raises(ValueError):  # float16 gradient
        roi_align.crop_and_resize_backward(g.half(), rois, idx, (2, 4, 4),
                                           1 / 16)
    with pytest.raises(ValueError):  # gradient and features of two dtypes
        roi_align.roi_pool_backward(g.bfloat16(), feats, rois, idx, 1 / 16)


@pytest.mark.parametrize("pooling", ["resize", "pooling"])
@pytest.mark.parametrize("n", [1, 2])
def test_head_forward_runs_pool_kernels(dev, pooling, n):
    """The head flattens grouped rois for the alternate poolers (contiguous
    int32 image indices at any batch) and agrees with its CPU run."""
    from mask_rcnn_tpu_torch.models import heads
    from mask_rcnn_tpu_torch.models.mask_rcnn import (
        map_params,
        set_float32_precision,
    )

    set_float32_precision()  # no TF32 in the float32 convs
    rng = np.random.RandomState(8)
    h, w, r = 5, 7, 6
    feats = torch.from_numpy(
        np.maximum(rng.randn(n, h, w, 1024), 0).astype(np.float32))
    rois = torch.from_numpy(np.stack(
        [random_boxes(rng, r, h * 16, w * 16, min_size=4) for _ in range(n)]))
    params = heads.init_head(torch.Generator().manual_seed(0), 3)
    want = heads.head_forward(params, feats, rois, pooling=pooling)
    kernel = roi_align.POOLING_FUNCS[pooling]
    before = kernel.launches
    got = heads.head_forward(map_params(lambda t: t.to(dev), params),
                             feats.to(dev), rois.to(dev), pooling=pooling)
    assert kernel.launches == before + 1
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=1e-4 * want[k].abs().max().item())
