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
from tests.torch_nms_cases import NMS_EDGE_CASES, dyadic_boxes, nms_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("c", [8, 70, 1024, 1032])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0),
                                                       (2, 2), (1, 3)])
def test_roi_align_kernel_matches_plain(dev, dtype, bin_stride,
                                        sampling_ratio, c):
    """C = 70 is not a multiple of K1's 16-byte channel group (the scalar
    form, with a tail); 8, 1024 and 1032 are (one, 128 and 129 bf16
    groups)."""
    rng = np.random.RandomState(0)
    n, h, w = 2, 13, 21
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


def spill_case(rng):
    """Small boxes scattered over a 4096 x 4096 image: nearly all survive,
    so 5000 outputs keep more boxes than K2 holds in shared memory."""
    boxes = dyadic_boxes(rng, 6000, 4096, 4, 16)[None]
    return boxes, rng.rand(1, 6000) > 0.05, 0.7, 5000


# (B, N, max_out) of random boxes at 0.7; the CPU tests' edge cases (n,
# max_out, thresh, size, lo, hi, clusters or edge kind); "spill".
NMS_BLOCKED_CASES = [(2, 12000, 2000), (1, 6000, 1000), (3, 1500, 300),
                     (2, 100, 150), (1, 1, 5), *NMS_EDGE_CASES, "spill"]


@pytest.mark.parametrize("case", NMS_BLOCKED_CASES, ids=str)
def test_nms_blocked_kernel_matches_plain(dev, case):
    if case == "spill":
        boxes, valid, thresh, max_out = spill_case(np.random.RandomState(9))
    elif len(case) == 3:
        b, n, max_out = case
        rng = np.random.RandomState(n)
        boxes = np.stack([random_boxes(rng, n, 300, 400, min_size=4)
                          for _ in range(b)])
        valid, thresh = rng.rand(b, n) > 0.1, 0.7
    else:
        n, max_out, thresh, size, lo, hi, kind = case
        boxes, _, valid = nms_case(0, n, size, lo, hi, kind)
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = nms.nms_blocked(boxes.to(dev), valid.to(dev), thresh, max_out)
    want = nms.nms_blocked_plain(boxes, valid, thresh, max_out)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if case == "spill":  # the kept set outgrew shared memory
        assert want[1].sum() > nms.nms_kept_cap()


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


def edge_rois(rng, n, r, h, w):
    """Per-image rois in image coordinates (feature stride 16), the edge
    cases first: partly outside (top-left, bottom-right), wholly outside
    (above-left, below-right: every sample skipped), zero-area (at the
    origin and inside the map), larger than the map, the whole map; then
    random boxes."""
    fixed = [[-20, -20, 40, 40],
             [h * 16 - 30, w * 16 - 30, h * 16 + 30, w * 16 + 30],
             [-300, -300, -100, -50],
             [h * 16 + 40, w * 16 + 40, h * 16 + 300, w * 16 + 200],
             [0, 0, 0, 0], [50, 60, 50, 60],
             [-64, -64, h * 16 + 64, w * 16 + 64], [0, 0, h * 16, w * 16]]
    rois = np.stack([random_boxes(rng, r, h * 16, w * 16, min_size=2)
                     for _ in range(n)])
    rois[:, :len(fixed)] = fixed
    return torch.from_numpy(rois)


@pytest.mark.parametrize("c", [8, 70, 1024, 1032])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0),
                                                       (1, 2), (2, 2)])
def test_roi_align_backward_kernel_edge_cases(dev, dtype, bin_stride,
                                              sampling_ratio, c):
    """K7's 16-byte form (C = 8, 1024, 1032: one, 128 and 129 bf16 groups)
    and scalar form with a tail (C = 70) on rois partly or wholly outside
    the map, zero-area and larger than the map."""
    rng = np.random.RandomState(c)
    n, h, w, r = 2, 13, 21, 40
    rois = edge_rois(rng, n, r, h, w).to(dev)
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
    # the wholly outside rois scatter nothing
    outside = torch.zeros_like(g)
    outside[:, 2:4] = g[:, 2:4]
    assert not roi_align.roi_align_grouped_backward(outside, rois,
                                                    *args).any()


@pytest.mark.parametrize("counts", [(1300, 700), (2000, 0)])
def test_flat_roi_align_backward_kernel_splits(dev, counts):
    """K13 at the flat head's split of 2000 rois over two images, and with
    all of them on the first image, at 1024 bf16 channels."""
    rng = np.random.RandomState(11)
    n, h, w, c = 2, 26, 42, 1024
    boxes = np.concatenate([random_boxes(rng, k, h * 16, w * 16, min_size=2)
                            for k in counts])
    idx = np.repeat(np.arange(n, dtype=np.int32), counts)
    perm = rng.permutation(len(idx))
    rois = torch.from_numpy(boxes[perm]).to(dev)
    idx = torch.from_numpy(idx[perm]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((len(idx), 7, 7, c), generator=gen,
                    device=dev).bfloat16()
    args = ((n, h, w), 1 / 16, 0, 2)
    got = roi_align.roi_align_backward(g, rois, idx, *args)
    want = roi_align.roi_align_backward_plain(g.float(), rois, idx, *args)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8,
                               atol=1e-5 * want.abs().max().item())
    if not counts[1]:
        assert not got[1].any()


def test_roi_align_backward_refuses_misaligned_grad(dev):
    """K7 and K13 read 16-byte groups of grad_out: a contiguous view 4 bytes
    into another tensor is refused by the wrappers; through autograd the
    incoming gradient is first copied to a 16-byte boundary."""
    c, shape = 8, (2, 5, 7, 7, 8)
    numel = int(np.prod(shape))
    buf = torch.randn(numel + 4, device=dev)
    g = buf[1:1 + numel].view(shape)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    rois = border_rois(np.random.RandomState(12), 2, 5, 4, 4).to(dev)
    idx = torch.arange(10, dtype=torch.int32, device=dev) // 5
    with pytest.raises(ValueError, match="16-byte"):
        roi_align.roi_align_grouped_backward(g, rois, (4, 4), 1 / 16)
    with pytest.raises(ValueError, match="16-byte"):
        roi_align.roi_align_backward(g.view(10, 7, 7, c), rois.view(10, 4),
                                     idx, (2, 4, 4), 1 / 16)
    f = torch.randn(2, 4, 4, c, device=dev, requires_grad=True)
    out = roi_align.roi_align_grouped(f, rois, 7, 1 / 16, 0, 2)
    (got,) = torch.autograd.grad(out, f, g, retain_graph=True)
    (want,) = torch.autograd.grad(out, f, g.clone())
    torch.testing.assert_close(got, want, rtol=1e-5,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 61, 91), (3, 17, 130),
                                   (1, 832, 1344)])
def test_stem_kernel_matches_plain(dev, dtype, shape):
    check_stem_kernel(dev, dtype, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 5, 7), (2, 13, 27),
                                   (3, 30, 45), (3, 38, 70), (1, 35, 33)])
def test_stem_kernel_edge_shapes(dev, dtype, shape):
    """H and W not multiples of 4 or 8, images smaller than one 8x8 pooled
    tile (32x32 pixels), a batch of 3; the bf16 (tensor-core) and float32
    (CUDA-core) forms."""
    check_stem_kernel(dev, dtype, shape)


def check_stem_kernel(dev, dtype, shape):
    from mask_rcnn_tpu_torch.models import resnet
    from mask_rcnn_tpu_torch.models.mask_rcnn import set_float32_precision

    set_float32_precision()
    gen = torch.Generator().manual_seed(0)
    params = resnet.init_extractor(gen)
    params = {"conv1": params["conv1"],
              "bn1": {"scale": torch.rand(64, generator=gen) + 0.25,
                      "bias": torch.randn(64, generator=gen)}}
    x = torch.randn(*shape, 3, generator=gen) * 60
    p = {k: {n: t.to(dev, dtype) for n, t in v.items()}
         for k, v in params.items()}
    got = resnet.stem_forward(p, x.to(dev, dtype))
    want = resnet.stem_forward_plain(
        {k: {n: t.float() for n, t in v.items()} for k, v in p.items()},
        x.to(dev, dtype).float())
    assert got.dtype == dtype and got.shape == want.shape
    scale = want.abs().max().item()
    if dtype == torch.float32:  # summation order: 1e-5 of the largest
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    else:  # one bf16 rounding of the float32 result + 1e-3 of the largest
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8,
                                   atol=1e-3 * scale)


def test_stem_kernel_refuses_gradients(dev):
    from mask_rcnn_tpu_torch.models import resnet

    params = resnet.init_extractor(torch.Generator().manual_seed(0))
    p = {k: {n: t.to(dev) for n, t in params[k].items()}
         for k in ("conv1", "bn1")}
    x = torch.randn(1, 32, 32, 3, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        resnet.stem_forward(p, x)
    with torch.no_grad():
        resnet.stem_forward(p, x)


@pytest.mark.parametrize("c", [8, 70, 1024, 1032])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0),
                                                       (2, 2)])
def test_flat_roi_align_kernels_match_plain(dev, dtype, bin_stride,
                                            sampling_ratio, c):
    rng = np.random.RandomState(1)
    n, h, w = 3, 13, 21
    feats = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    rois = random_boxes(rng, 53, h * 16, w * 16, min_size=2)
    rois[:3] = [[-20, -20, 40, 40], [h * 16 - 30, w * 16 - 30,
                                     h * 16 + 30, w * 16 + 30], [0, 0, 0, 0]]
    idx = torch.from_numpy(rng.randint(0, n, 53).astype(np.int32)).to(dev)
    rois = torch.from_numpy(rois).to(dev)
    f = feats.to(dev, dtype)
    args = (7, 1 / 16, sampling_ratio, bin_stride)
    got = roi_align.roi_align(f, rois, idx, *args)
    want = roi_align.roi_align_plain(f.float(), rois, idx, *args)
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)
    g = torch.randn(got.shape, device=dev).to(dtype)
    got = roi_align.roi_align_backward(g, rois, idx, (n, h, w), 1 / 16,
                                       sampling_ratio, bin_stride)
    want = roi_align.roi_align_backward_plain(g.float(), rois, idx,
                                              (n, h, w), 1 / 16,
                                              sampling_ratio, bin_stride)
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())


def test_roi_align_refuses_misaligned_features(dev):
    """K1 and K4 read 16-byte channel groups: a contiguous view 4 bytes
    into another tensor is refused, not read misaligned."""
    buf = torch.zeros(2 * 4 * 4 * 8 + 4, device=dev)
    feats = buf[1:1 + 2 * 4 * 4 * 8].view(2, 4, 4, 8)
    assert feats.is_contiguous() and feats.data_ptr() % 16 == 4
    rois = torch.zeros((2, 3, 4), device=dev)
    idx = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        roi_align.roi_align_grouped(feats, rois, 7, 1 / 16)
    with pytest.raises(ValueError, match="16-byte"):
        roi_align.roi_align(feats, rois[0], idx, 7, 1 / 16)
    aligned = buf[4:4 + 2 * 4 * 4 * 8].view(2, 4, 4, 8)  # 16 bytes in
    roi_align.roi_align_grouped(aligned, rois, 7, 1 / 16)


def test_flat_roi_align_refuses_bad_indices(dev):
    feats = torch.zeros(2, 8, 8, 32, device=dev)
    rois = torch.zeros(3, 4, device=dev)
    for idx in ([0, 2, 1], [-1, 0, 0]):
        with pytest.raises(ValueError, match="roi_indices"):
            roi_align.roi_align(feats, rois, torch.tensor(
                idx, dtype=torch.int32, device=dev), 7, 1 / 16)
    with pytest.raises(ValueError, match="int32"):
        roi_align.roi_align(feats, rois, torch.zeros(3, dtype=torch.int64,
                                                     device=dev), 7, 1 / 16)


def test_flat_head_runs_flat_kernels(dev):
    from mask_rcnn_tpu_torch.models import heads
    from mask_rcnn_tpu_torch.models.mask_rcnn import map_params

    params = map_params(lambda t: t.to(dev),
                        heads.init_head(torch.Generator().manual_seed(0), 5))
    feats = torch.randn(2, 4, 6, 1024, device=dev, requires_grad=True)
    rois = torch.tensor([[0, 0, 40, 60], [8, 8, 50, 90], [4, 0, 64, 96]],
                        dtype=torch.float32, device=dev)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    roi_align.roi_align.launches = 0
    roi_align.roi_align_backward.launches = 0
    out = heads.head_forward(params, feats, rois, roi_indices=idx)
    (out["scores"].sum() + out["masks"].sum()).backward()
    assert roi_align.roi_align.launches == 1
    assert roi_align.roi_align_backward.launches == 1
    assert feats.grad is not None and feats.grad.abs().sum() > 0
