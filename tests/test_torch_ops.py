"""The port's ops (``mask_rcnn_tpu_torch.ops``) against the JAX package's
and the numpy oracles, on the CPU: the same seeded numpy inputs through
both, each comparison with its stated tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.ops import anchors as jax_anchors
from mask_rcnn_tpu.ops import boxes as jax_boxes
from mask_rcnn_tpu.ops.nms import nms_padded as jax_nms_padded
from mask_rcnn_tpu.ops.roi_align import (
    roi_align_grouped as jax_roi_align_grouped,
)
from mask_rcnn_tpu_torch.ops import anchors, boxes, nms, roi_align
from tests.oracles import loc2bbox_np, nms_np, random_boxes, roi_align_np
from tests.torch_nms_cases import NMS_EDGE_CASES, dyadic_boxes, nms_case


def test_anchors_match_jax():
    for ratios, scales in [((0.5, 1.0, 2.0), (2.0, 4.0, 8.0, 16.0, 32.0)),
                           ((1.0,), (1.0, 2.0))]:
        base = anchors.generate_anchor_base(16.0, ratios, scales)
        want = jax_anchors.generate_anchor_base(16.0, ratios, scales)
        np.testing.assert_allclose(base, want, rtol=0, atol=1e-6)
        got = anchors.enumerate_shifted_anchors(base, 16, 5, 7)
        want = jax_anchors.enumerate_shifted_anchors(want, 16, 5, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_boxes_match_jax_and_oracle():
    rng = np.random.RandomState(0)
    src = random_boxes(rng, 64, 200, 300, min_size=2)
    loc = (rng.randn(64, 4) * 0.3).astype(np.float32)
    got = boxes.loc2bbox(torch.from_numpy(src), torch.from_numpy(loc)).numpy()
    want = np.asarray(jax_boxes.loc2bbox(jnp.asarray(src), jnp.asarray(loc)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, loc2bbox_np(src, loc), rtol=1e-6,
                               atol=1e-4)

    wide = src * 1.5 - 40.0
    got = boxes.clip_boxes(torch.from_numpy(wide), (200, 300)).numpy()
    want = np.asarray(jax_boxes.clip_boxes(jnp.asarray(wide), (200, 300)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = boxes.bbox_area(torch.from_numpy(wide)).numpy()
    want = np.asarray(jax_boxes.bbox_area(jnp.asarray(wide)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# (n, max_out, thresh, image size, box sizes lo..hi, clusters or edge case)
NMS_CASES = [
    (6000, 1000, 0.7, 1024, 8, 128, 1500),  # proposal path (blocked, K2)
    (256, 100, 0.5, 128, 4, 48, 30),  # decode path (fixpoint, K3)
    (256, 100, 0.5, 256, 4, 48, 160),  # decode, truncated at max_out
]


@pytest.mark.parametrize("n,max_out,thresh,size,lo,hi,clusters",
                         NMS_CASES[:2] + NMS_EDGE_CASES)
def test_nms_padded_matches_jax(n, max_out, thresh, size, lo, hi, clusters):
    """The port's nms_padded (K2's plain version nms_blocked_plain above
    SMALL_MAX_N boxes) against the jitted JAX nms_padded, batched over
    problems; above SMALL_MAX_N the JAX side takes nms_blocked_mask."""
    bbox, score, valid = nms_case(0, n, size, lo, hi, clusters)
    got_idx, got_mask = nms.nms_padded(
        torch.from_numpy(bbox), torch.from_numpy(score), thresh, max_out,
        valid=torch.from_numpy(valid), presorted=True,
    )
    # JAX takes its blocked path by itself from N = 4096; below, ask for it
    block = 256 if nms.SMALL_MAX_N < n < 4096 else None
    jax_nms = jax.jit(
        lambda b, s, v: jax_nms_padded(b, s, thresh, max_out, valid=v,
                                       presorted=True, block=block)
    )
    for i in range(len(bbox)):
        want_idx, want_mask = jax_nms(bbox[i], score[i], valid[i])
        np.testing.assert_array_equal(got_idx[i].numpy(),
                                      np.asarray(want_idx))
        np.testing.assert_array_equal(got_mask[i].numpy(),
                                      np.asarray(want_mask))
    assert got_mask.any() == valid.any()


@pytest.mark.parametrize("n,max_out,thresh,size,lo,hi,clusters", NMS_CASES)
def test_nms_padded_matches_greedy_oracle(n, max_out, thresh, size, lo, hi,
                                          clusters):
    """Unsorted input through the internal stable sort, on both paths,
    truncation at ``max_out`` and -1 padding included."""
    bbox, score, valid = nms_case(1, n, size, lo, hi, clusters)
    bbox, score, valid = bbox[0], score[0], valid[0]
    perm = np.random.RandomState(2).permutation(n)
    bbox, score, valid = bbox[perm], score[perm], valid[perm]
    idx, mask = nms.nms_padded(
        torch.from_numpy(bbox)[None], torch.from_numpy(score)[None], thresh,
        max_out, valid=torch.from_numpy(valid)[None],
    )
    got = idx[0][mask[0]].numpy()
    # The first max_out survivors depend only on the boxes up to the last
    # one returned, so the quadratic oracle runs on that prefix.
    order = np.argsort(-np.where(valid, score, -np.inf), kind="stable")
    order = order[valid[order]]
    stop = np.flatnonzero(order == got[-1])[0] + 1 if len(got) == max_out \
        else len(order)
    keep = nms_np(bbox[order[:stop]], score[order[:stop]], thresh)
    want = order[:stop][keep][:max_out]
    np.testing.assert_array_equal(got, want)
    assert (idx[0][~mask[0]] == -1).all()


def test_nms_small_and_blocked_agree():
    """Both plain paths are the exact greedy answer, batched over problems."""
    rng = np.random.RandomState(3)
    bbox = np.stack([dyadic_boxes(rng, 300, 128, 4, 40, 60)
                     for _ in range(3)])
    valid = rng.rand(3, 300) > 0.1
    b, v = torch.from_numpy(bbox), torch.from_numpy(valid)
    small = nms.nms_small_plain(b, v, 0.5, 120)
    blocked = nms.nms_blocked_plain(b, v, 0.5, 120, block=64)
    np.testing.assert_array_equal(small[0].numpy(), blocked[0].numpy())
    np.testing.assert_array_equal(small[1].numpy(), blocked[1].numpy())


def roi_case(seed, n=2, h=12, w=16, c=5, r=9):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, h, w, c).astype(np.float32)
    rois = np.stack(
        [random_boxes(rng, r, h * 16, w * 16, min_size=4) for _ in range(n)]
    )
    # border rois: hanging past every edge, sub-pixel, at the far corner
    rois[:, 0] = [-20.0, -20.0, 40.0, 40.0]
    rois[:, 1] = [h * 16 - 30, w * 16 - 30, h * 16 + 30, w * 16 + 30]
    rois[:, 2] = [0.0, 0.0, 4.0, 4.0]
    rois[:, 3] = [h * 16 - 8, w * 16 - 8, h * 16, w * 16]
    return feats, rois


@pytest.mark.parametrize("bin_stride", [1, 2])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("shape", [(12, 16), (16, 12)])
def test_roi_align_grouped_matches_jax_and_oracle(bin_stride, sampling_ratio,
                                                  shape):
    h, w = shape
    feats, rois = roi_case(4, h=h, w=w)
    got = roi_align.roi_align_grouped(
        torch.from_numpy(feats), torch.from_numpy(rois), 7, 1 / 16,
        sampling_ratio, bin_stride,
    ).numpy()
    want = np.asarray(jax_roi_align_grouped(
        jnp.asarray(feats), jnp.asarray(rois), out_size=7,
        spatial_scale=1 / 16, sampling_ratio=sampling_ratio,
        bin_stride=bin_stride,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    n, r = rois.shape[:2]
    full = roi_align_np(
        feats, rois.reshape(-1, 4), np.repeat(np.arange(n), r),
        7 * bin_stride, 1 / 16, sampling_ratio,
    ).reshape(n, r, 7 * bin_stride, 7 * bin_stride, -1)
    # bin_stride s: bins (0, s, 2s, ...) of the oracle's 7*s grid
    np.testing.assert_allclose(
        got, full[:, :, ::bin_stride, ::bin_stride], rtol=1e-5, atol=1e-5
    )


def test_roi_align_keeps_bf16_and_rejects_other_devices():
    feats, rois = roi_case(5)
    f = torch.from_numpy(feats).to(torch.bfloat16)
    out = roi_align.roi_align_grouped(f, torch.from_numpy(rois), 7, 1 / 16)
    assert out.dtype == torch.bfloat16
    ref = roi_align.roi_align_grouped(f.float(), torch.from_numpy(rois), 7,
                                      1 / 16)
    # one bf16 rounding of the float32 result
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=2 ** -8, atol=1e-6)
    with pytest.raises(ValueError):
        roi_align.roi_align_grouped(f.to("meta"), torch.from_numpy(rois), 7,
                                    1 / 16)
