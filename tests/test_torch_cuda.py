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
from tests.torch_decode_cases import DECODE_CARD_CASES, decode_case
from tests.torch_nms_cases import NMS_EDGE_CASES, dyadic_boxes, nms_case
from tests.torch_target_cases import CARD_CASES, anchor_case, proposal_case

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


# The K2 edge cases at N <= SMALL_MAX_N, where nms_padded takes nms_small.
NMS_SMALL_EDGE_CASES = [(1000, *case[1:]) for case in NMS_EDGE_CASES]


@pytest.mark.parametrize("case", NMS_SMALL_EDGE_CASES, ids=str)
def test_nms_small_kernel_edge_cases(dev, case):
    n, max_out, thresh, size, lo, hi, kind = case
    boxes, _, valid = nms_case(0, n, size, lo, hi, kind)
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = nms.nms_small.launches
    got = nms.nms_small(boxes.to(dev), valid.to(dev), thresh, max_out)
    want = nms.nms_small_plain(boxes, valid, thresh, max_out)
    assert nms.nms_small.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def decode_on_card(dev, name):
    """Case ``name``'s decode prologue on the card: (cls_bbox, prob,
    roi_valid) and the selection's arguments."""
    from mask_rcnn_tpu_torch.models import mask_rcnn

    cfg_kw, (roi, valid, cls_loc, score, sizes, scales) = decode_case(name)
    cfg = mask_rcnn.MaskRCNNConfig(**cfg_kw)
    t = [torch.from_numpy(a).to(dev)
         for a in (roi, cls_loc, score, sizes, scales)]
    cls_bbox, prob = mask_rcnn.decode_boxes(cfg, *t)
    return ((cls_bbox, prob, torch.from_numpy(valid).to(dev)),
            (cfg.score_thresh, cfg.nms_topk_per_class, cfg.nms_thresh,
             cfg.detections_per_im), cfg, t)


@pytest.mark.parametrize("name", sorted(DECODE_CARD_CASES))
def test_decode_kernel_matches_plain(dev, name):
    """The decode kernel against its plain twin on the same card inputs:
    boxes, labels, scores and valid bit for bit; one launch a decode."""
    from mask_rcnn_tpu_torch.models import mask_rcnn

    inputs, args, cfg, t = decode_on_card(dev, name)
    want = nms.decode_select_plain(*inputs, *args)
    before = nms.decode_select.launches
    got = mask_rcnn.decode(cfg, t[0], inputs[2], *t[1:])
    assert nms.decode_select.launches == before + 1
    again = nms.decode_select(*inputs, *args)  # the tickets were reset
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        assert torch.equal(a, w)
    if name == "all_invalid_image":
        assert not want[3][1].any() and want[3][0].any()
    if name == "fewer_than_d":
        assert 0 < want[3].sum(1).max() < args[-1]


def test_decode_wrapper_rejects_what_the_kernel_does_not_take(dev):
    (cls_bbox, prob, valid), args, _, _ = decode_on_card(dev, "ties")
    for bad in (
        (cls_bbox.cpu(), prob, valid),  # boxes on the CPU
        (cls_bbox, prob, valid.cpu()),  # validity on the CPU
        (cls_bbox, prob.double(), valid),  # float64 probabilities
        (cls_bbox.double(), prob, valid),  # float64 boxes
        (cls_bbox, prob, valid.int()),  # int validity
        (cls_bbox[:, :-1], prob, valid),  # one roi short
        (cls_bbox, prob[..., :-1], valid),  # one class short
        (cls_bbox.transpose(0, 1), prob.transpose(0, 1),
         valid.t().contiguous()),  # not contiguous
    ):
        with pytest.raises(ValueError):
            nms.decode_select(*bad, *args)
    rp = nms.decode_limits()["rows"] + 1  # more rows than the kernel takes
    with pytest.raises(ValueError):
        nms.decode_select(
            torch.zeros((1, rp, 3, 4), device=dev),
            torch.zeros((1, rp, 3), device=dev),
            torch.ones((1, rp), dtype=torch.bool, device=dev), *args)
    with pytest.raises(ValueError):  # n_fg * d over the merge's keys
        nms.decode_select(
            torch.zeros((1, 8, 101, 4), device=dev),
            torch.zeros((1, 8, 101), device=dev),
            torch.ones((1, 8), dtype=torch.bool, device=dev),
            0.05, 0, 0.5, 100)


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


def as_torch(case, *keys):
    return [torch.from_numpy(np.ascontiguousarray(case[k])) for k in keys]


@pytest.mark.parametrize("case", CARD_CASES)
def test_anchor_targets_kernel_matches_plain(dev, case):
    """K9a against its plain version on the card (the same libm): labels
    identical, locs within 1e-6."""
    from mask_rcnn_tpu_torch.ops import targets

    c = anchor_case(case)
    args = [a.to(dev) for a in as_torch(c, "bbox", "bbox_valid", "anchors")]
    pri = [a.to(dev) for a in as_torch(c, "pri_pos", "pri_neg")]
    cfg = targets.AnchorTargetConfig(n_sample=c["n_sample"])
    before = targets.anchor_targets.launches
    loc, label = targets.anchor_targets(*args, c["img_size"], *pri, cfg)
    assert targets.anchor_targets.launches == before + 1
    want_loc, want_label = targets.anchor_targets_plain(
        *args, c["img_size"], *pri, cfg)
    assert label.dtype == torch.int32 and loc.shape == want_loc.shape
    assert torch.equal(label, want_label)
    torch.testing.assert_close(loc, want_loc, rtol=1e-6, atol=1e-6)
    assert (want_label == 1).any() and (want_label == 0).any()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", CARD_CASES)
def test_proposal_targets_kernel_matches_plain(dev, case, packed):
    """K9b + K8 against their plain version on the card: sample rois,
    labels and masks identical (unfilled slots included), locs within
    1e-6."""
    from mask_rcnn_tpu_torch.ops import targets

    from mask_rcnn_tpu_torch.data.loader import pack_mask_bits

    c = proposal_case(case)
    if packed:
        c["masks"] = pack_mask_bits(c["masks"])
    args = [a.to(dev) for a in as_torch(
        c, "roi", "roi_valid", "bbox", "label", "bbox_valid", "masks",
        "pri_pos", "pri_neg")]
    cfg = targets.ProposalTargetConfig(n_sample=c["n_sample"])
    norm = ((0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    before = targets.proposal_targets.launches
    got = targets.proposal_targets(*args, cfg, *norm, packed)
    assert targets.proposal_targets.launches == before + 1
    want = targets.proposal_targets_plain(*args, cfg, *norm, packed)
    for k in (0, 2, 3):
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert (want[3] >= 0).any()


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
def test_proposal_targets_kernel_masks_at_exact_ties(dev, packed):
    """K8 inside K9b on crops of 28 and 14 pixels at even and odd offsets
    (exact-0.5 interpolations), half-integer boxes (rounded half to even),
    a box at the image's corner, a sub-pixel gt (its rounded crop is empty
    and clamps to one pixel) and the whole image: identical to the plain
    version."""
    from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
    from mask_rcnn_tpu_torch.ops import targets

    rng = np.random.RandomState(3)
    n, h, w = 2, 64, 96
    ties = np.array([[0, 0, 28, 28], [2, 4, 30, 32], [1, 3, 29, 17],
                     [10.5, 11.5, 38.5, 25.5], [h - 3, w - 3, h, w],
                     [3.5, 2.5, 31.5, 30.5], [5, 5, 5.4, 5.4],
                     [0, 0, h, w]], np.float32)
    bbox = np.stack([ties] * n)
    g = len(ties)
    roi = np.stack([np.concatenate([ties, random_boxes(rng, 40, h, w)])
                    for _ in range(n)])
    masks = tie_masks(rng, n, g, h, w)
    m = pack_mask_bits(masks) if packed else masks
    pri_pos = rng.rand(n, roi.shape[1] + g).astype(np.float32)
    pri_pos[:, -2:] = 2.0  # the sub-pixel and whole-image gts lead
    arrays = (roi, rng.rand(n, len(roi[0])) > 0.05, bbox,
              rng.randint(0, 80, (n, g)).astype(np.int32),
              np.ones((n, g), bool), m, pri_pos,
              rng.rand(n, roi.shape[1] + g).astype(np.float32))
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    cfg = targets.ProposalTargetConfig(n_sample=64)  # 16 positive slots
    norm = ((0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    got = targets.proposal_targets(*args, cfg, *norm, packed)
    want = targets.proposal_targets_plain(*args, cfg, *norm, packed)
    for k in (0, 2, 3):
        assert torch.equal(got[k], want[k]), k
    assert (want[2] > 0).sum() >= 2 * g  # the tie crops are sampled
    # both edge gts take the first two slots as positive crops
    assert torch.equal(want[0][:, :2].cpu(), torch.from_numpy(bbox[:, -2:]))
    assert (want[2][:, :2] > 0).all() and (want[3][:, :2] >= 0).all()


def test_target_wrappers_reject_what_the_kernels_do_not_take(dev):
    from mask_rcnn_tpu_torch.ops import targets

    acfg, pcfg = targets.AnchorTargetConfig(), targets.ProposalTargetConfig()
    norm = ((0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    assert targets.kernel_limits() == (256, 8 * 24576, 4096)
    anchors = torch.zeros((10, 4), device=dev)
    bbox = torch.zeros((1, 3, 4), device=dev)
    valid = torch.ones((1, 3), dtype=torch.bool, device=dev)
    pri = torch.zeros((1, 10), device=dev)
    with pytest.raises(ValueError, match="196608"):  # too many anchors
        big = torch.zeros((8 * 24576 + 1, 4), device=dev)
        big_pri = torch.zeros((1, len(big)), device=dev)
        targets.anchor_targets(bbox, valid, big, (8, 8), big_pri, big_pri,
                               acfg)
    with pytest.raises(ValueError):  # float64 anchors
        targets.anchor_targets(bbox, valid, anchors.double(), (8, 8), pri,
                               pri, acfg)
    with pytest.raises(ValueError):  # no gt slot
        targets.anchor_targets(bbox[:, :0], valid[:, :0], anchors, (8, 8),
                               pri, pri, acfg)
    with pytest.raises(ValueError):  # more gt boxes than shared memory holds
        targets.anchor_targets(
            torch.zeros((1, 257, 4), device=dev),
            torch.ones((1, 257), dtype=torch.bool, device=dev), anchors,
            (8, 8), pri, pri, acfg)
    with pytest.raises(ValueError):  # priorities of another shape
        targets.anchor_targets(bbox, valid, anchors, (8, 8), pri[:, :9],
                               pri, acfg)
    roi = torch.zeros((1, 5, 4), device=dev)
    roi_valid = torch.ones((1, 5), dtype=torch.bool, device=dev)
    label = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    masks = torch.zeros((1, 3, 8, 1), dtype=torch.uint8, device=dev)
    ppri = torch.zeros((1, 8), device=dev)
    with pytest.raises(ValueError):  # validity as uint8
        targets.proposal_targets(roi, roi_valid, bbox, label, valid.byte(),
                                 masks, ppri, ppri, pcfg, *norm, True)
    with pytest.raises(ValueError):  # int64 labels
        targets.proposal_targets(roi, roi_valid, bbox, label.long(), valid,
                                 masks, ppri, ppri, pcfg, *norm, True)
    with pytest.raises(ValueError):  # non-contiguous rois
        targets.proposal_targets(roi.transpose(0, 1), roi_valid, bbox,
                                 label, valid, masks, ppri, ppri, pcfg,
                                 *norm, True)
    with pytest.raises(ValueError, match="4096"):  # too many candidates
        big = torch.zeros((1, 4094, 4), device=dev)
        targets.proposal_targets(
            big, torch.ones((1, 4094), dtype=torch.bool, device=dev), bbox,
            label, valid, masks, torch.zeros((1, 4097), device=dev),
            torch.zeros((1, 4097), device=dev), pcfg, *norm, True)
    # the plain-only parts refuse CUDA tensors and name the kernel
    with pytest.raises(ValueError, match="anchor_targets"):
        targets.anchor_match(anchors, bbox, valid, (8, 8), .7, .3)
    with pytest.raises(ValueError, match="proposal_targets"):
        targets.proposal_match(roi, roi_valid, bbox, valid, .5, .5, 0.)
    with pytest.raises(ValueError, match="proposal_targets"):
        targets.mask_crop_resize(masks, torch.zeros((1, 2), dtype=torch.int64,
                                                    device=dev),
                                 roi[:, :2], 14, True)
    with pytest.raises(ValueError):  # unsupported grad dtype
        roi_align.roi_align_grouped_backward(
            torch.zeros((1, 2, 7, 7, 8), dtype=torch.float16, device=dev),
            roi[:, :2], (4, 4), 1 / 16)


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


def pool_edge_rois(rng, n, h, w, r):
    """Flat rois on an (n, h, w) map (feature stride 16): the whole map,
    rois of extent < 14 (overlapping bins; crops narrower than the output),
    crop width and height 1, rois past the far borders (border taps with
    low == high), one past every border (bins at the full ceil(size/P) + 1
    rows and columns), a zero slot, then random boxes; image indices with
    the two images interleaved and two out of range (-1 and n)."""
    fixed = np.array([
        [0, 0, h * 16, w * 16], [0, 0, 5 * 16, 3 * 16],
        [32, 48, 32 + 20 * 16, 48 + 15 * 16], [40, 40, 40, 40],
        [100, 60, 100, 60 + 9 * 16], [100, 60, 100 + 9 * 16, 60],
        [h * 16 - 100, w * 16 - 90, h * 16 + 200, w * 16 + 300],
        [-400, -400, h * 16 + 400, w * 16 + 400], [0, 0, 0, 0],
    ], np.float32)
    rois = np.concatenate([fixed, random_boxes(rng, r - len(fixed), h * 16,
                                               w * 16, min_size=8)])
    idx = (np.arange(r) % n).astype(np.int32)
    idx[[9, 10]] = [-1, n]
    return torch.from_numpy(rois), torch.from_numpy(idx)


def misaligned(x):
    """A copy of x whose data pointer sits one element past a 16-byte
    boundary (a view at an odd offset into a larger buffer, contiguous)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


@pytest.mark.parametrize("p", [14, 7, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 72, 70])
def test_crop_and_resize_backward_kernel_edge_cases(dev, dtype, c, p):
    """K11 at the 1344x832 bucket's features on the rois of
    :func:`pool_edge_rois` (crop width 1, border taps with low == high,
    out-of-range indices: no gradient), with the gradient res5's stride-2
    1x1 convs send (zero on every odd py or odd px) and zero whole rois,
    then a dense one. C = 1024 takes the 16-byte vector form; 72 is a
    multiple of 4 but not of 8 (float32 vectors, bf16 one channel a thread);
    70 neither; a misaligned gradient takes the one-channel form."""
    rng = np.random.RandomState(13)
    n, h, w, r = 2, 84, 52, 40
    rois, idx = pool_edge_rois(rng, n, h, w, r)
    rd, i = rois.to(dev), idx.to(dev)
    g = rng.randn(r, p, p, c).astype(np.float32)
    s2 = g.copy()
    s2[:, 1::2] = 0.0
    s2[:, :, 1::2] = 0.0
    s2[::7] = 0.0
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    for grad in (s2, g):
        gd = torch.from_numpy(grad).to(dev, dtype)
        want = roi_align.crop_and_resize_backward_plain(
            gd.float(), rd, i, (n, h, w), 1 / 16)
        if grad is g:  # border taps reach the last row and column
            assert (want[:, -1] != 0).any() and (want[:, :, -1] != 0).any()
        for gk in (gd, misaligned(gd)):
            got = roi_align.crop_and_resize_backward(gk, rd, i, (n, h, w),
                                                     1 / 16)
            assert got.dtype == dtype and got.is_contiguous()
            # the float32 atomics' order, and one bf16 rounding
            torch.testing.assert_close(got.float(), want, rtol=rtol,
                                       atol=1e-5 * want.abs().max().item())


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


@pytest.mark.parametrize("p", [14, 7, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 72, 70])
def test_roi_pool_kernel_edge_cases(dev, dtype, c, p):
    """K6 at the 1344x832 bucket's features (H = 84, W = 52) on tied relu'd
    values and the rois of :func:`pool_edge_rois`: overlapping bins, bins at
    the full ceil(size/P) + 1 rows and columns, empty bins, and rois of an
    out-of-range index, which pool zeros. C = 1024 takes the 16-byte vector
    form; 72 is a multiple of 4 but not of 8 (float32 vectors, bf16 one
    channel a thread); 70 neither; misaligned features take the
    one-channel form. The max is exact: identical to the plain version."""
    rng = np.random.RandomState(14)
    n, h, w, r = 2, 84, 52, 40
    f = tie_features(rng, n, h, w, c).to(dev, dtype)
    rois, idx = pool_edge_rois(rng, n, h, w, r)
    rd, i = rois.to(dev), idx.to(dev)
    ok = (i >= 0) & (i < n)
    want = roi_align.roi_pool_plain(f, rd[ok], i[ok], p, 1 / 16)
    assert (want == 0).any()
    for fk in (f, misaligned(f)):
        got = roi_align.roi_pool(fk, rd, i, p, 1 / 16)
        assert got.dtype == dtype and got.shape == (r, p, p, c)
        assert torch.equal(got[ok], want)
        assert not got[~ok].any()  # another image's index pools zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 70])
def test_roi_pool_kernel_nonfinite_bins_give_zero(dev, dtype, c):
    """A bin that holds a NaN or +inf pools to 0, as the plain version
    and the JAX function give (tests/test_torch_pooling.py); -inf beside
    finite values is an ordinary value. A max that drops the NaN (fmaxf)
    returns the bin's other maximum instead."""
    rng = np.random.RandomState(15)
    n, h, w, r = 2, 26, 42, 60
    feats = rng.randn(n, h, w, c).astype(np.float32)
    flat = feats.reshape(-1)
    spots = rng.choice(flat.size, 3 * flat.size // 200, replace=False)
    k = len(spots) // 3
    flat[spots[:k]] = np.nan
    flat[spots[k:2 * k]] = np.inf
    flat[spots[2 * k:]] = -np.inf
    feats[1, 4:12, 6:20] = -np.inf
    f = torch.from_numpy(feats).to(dev, dtype)
    rois, idx = flat_edge_rois(rng, n, h, w, r)
    rd, i = rois.to(dev), idx.to(dev)
    for p in (14, 7):
        want = roi_align.roi_pool_plain(f, rd, i, p, 1 / 16)
        got = roi_align.roi_pool(f, rd, i, p, 1 / 16)
        assert torch.isfinite(want).all()
        assert torch.equal(got, want)


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


@pytest.mark.parametrize("p", [14, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 72, 70])
def test_roi_pool_backward_kernel_edge_cases(dev, dtype, c, p):
    """K12 at the 1344x832 bucket's features (H = 84: bins of up to 7 rows
    at P = 14, 8-bit tie masks; up to 13 rows at P = 7, 32-bit ones) on
    tied relu'd values: rois whose bins share a boundary
    column (extents that are not multiples of 14, the whole map), gradient
    rows that are all zero (every odd py, as under res5's stride-2 convs,
    and whole rois), the rois of two images interleaved. C = 1024 takes the
    16-byte vector form; 72 is a multiple of 4 but not of 8 (float32
    vectors, bf16 one channel a thread); 70 neither. An integer cotangent
    makes every weighted sum exact: identical; a random one within one
    bf16 rounding and the atomics' order."""
    rng = np.random.RandomState(11)
    n, h, w, r = 2, 84, 52, 40
    feats = tie_features(rng, n, h, w, c)
    fixed = np.array([
        [0, 0, h * 16, w * 16], [32, 48, 32 + 20 * 16, 48 + 15 * 16],
        [100, 60, 100 + 17 * 16, 60 + 23 * 16], [0, 0, 5 * 16, 3 * 16],
        [h * 16 - 300, w * 16 - 200, h * 16 + 50, w * 16 + 40],
    ], np.float32)
    rois = np.concatenate([fixed, random_boxes(rng, r - len(fixed), h * 16,
                                               w * 16, min_size=8)])
    idx = (np.arange(r) % 2).astype(np.int32)
    f = feats.to(dev, dtype)
    rd, i = torch.from_numpy(rois).to(dev), torch.from_numpy(idx).to(dev)
    g = rng.randint(-4, 5, (r, p, p, c)).astype(np.float32)
    g[:, 1::2] = 0.0  # odd rows of bins
    g[::7] = 0.0  # whole rois
    g = torch.from_numpy(g).to(dev, dtype)
    got = roi_align.roi_pool_backward(g, f, rd, i, 1 / 16)
    want = roi_align.roi_pool_backward_plain(g, f, rd, i, 1 / 16)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    assert (want.float() != want.float().round()).any()  # ties split
    g = torch.from_numpy(rng.randn(r, p, p, c).astype(np.float32))
    g[:, 1::2] = 0.0
    g = g.to(dev, dtype)
    got = roi_align.roi_pool_backward(g, f, rd, i, 1 / 16)
    want = roi_align.roi_pool_backward_plain(g.float(), f.float(), rd, i,
                                             1 / 16)
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())


def test_roi_pool_backward_refuses_bins_over_32_rows(dev):
    """The kernel keeps a column's tied rows in a 32-bit mask."""
    feats = torch.zeros((1, 70, 8, 8), device=dev)
    rois = torch.tensor([[0.0, 0.0, 1000.0, 100.0]], device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    g = torch.ones((1, 2, 2, 8), device=dev)
    with pytest.raises(ValueError):
        roi_align.roi_pool_backward(g, feats, rois, idx, 1 / 16)


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
