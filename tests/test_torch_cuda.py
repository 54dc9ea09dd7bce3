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


@pytest.mark.parametrize("b,n,max_out", [(1, 6000, 1000), (3, 1500, 300),
                                         (2, 100, 150), (1, 1, 5)])
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
