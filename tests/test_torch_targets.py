"""The port's training-side ops against the JAX package on the CPU:
``bbox_iou``/``bbox2loc``, the losses, the plain versions of the RoIAlign
backward (K7), the mask-target crop-resize (K8), the anchor/proposal
matching, and both target creators (the plain versions of K9a and K9b).
The same seeded numpy inputs go through both; the creators get the
priorities that ``jax.random.uniform`` draws on the JAX package's keys, or,
at the edge cases, given priorities that the JAX creators are made to use.
Each comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import targets as jax_targets
from mask_rcnn_tpu.ops import boxes as jax_boxes
from mask_rcnn_tpu.ops import losses as jax_losses
from mask_rcnn_tpu.ops.roi_align import (
    roi_align_grouped as jax_roi_align_grouped,
)
from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
from mask_rcnn_tpu_torch.models import mask_rcnn, targets
from mask_rcnn_tpu_torch.ops import boxes, losses, roi_align
from mask_rcnn_tpu_torch.ops import targets as target_ops
from tests.oracles import random_boxes
from tests.torch_target_cases import (
    CPU_CASES,
    anchor_case,
    proposal_case,
    threshold_ties,
)


def jax_priorities(key, n, size):
    """The priorities ``_sample_masked`` draws inside the JAX creators for
    per-image keys ``split(key, n)``: (positives, negatives), (n, size)."""
    pos, neg = [], []
    for k in jax.random.split(key, n):
        kpos, kneg = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kpos, (size,))))
        neg.append(np.asarray(jax.random.uniform(kneg, (size,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# boxes and losses


def test_bbox_iou_and_bbox2loc_identical_to_jax_on_dyadic_boxes():
    rng = np.random.RandomState(0)
    a = (rng.randint(0, 64, (40, 4)) / 4.0).astype(np.float32)
    b = (rng.randint(0, 64, (9, 4)) / 4.0).astype(np.float32)
    a[:3] = [[0, 0, 0, 0], [4, 4, 2, 2], [1, 1, 9, 9]]  # empty, inverted
    b[0] = a[2]  # an exact match: IoU 1
    got = boxes.bbox_iou(t(a), t(b)).numpy()
    want = np.asarray(jax_boxes.bbox_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert (got == 1).any()
    # batched leading dims
    got2 = boxes.bbox_iou(t(np.stack([a, a[::-1]])),
                          t(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(got2[0], want)
    np.testing.assert_array_equal(got2[1], want[::-1])

    src = (rng.randint(0, 64, (40, 4)) / 4.0).astype(np.float32)
    src[:, 2:] += src[:, :2] + 0.25
    got = boxes.bbox2loc(t(src), t(a)).numpy()
    want = np.asarray(jax_boxes.bbox2loc(jnp.asarray(src), jnp.asarray(a)))
    # log and division: the same ops, up to libm's last bit
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_losses_match_jax(ignored):
    rng = np.random.RandomState(1)
    n, c = 50, 7
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    loc = rng.randn(n, 4).astype(np.float32)
    gt_loc = rng.randn(n, 4).astype(np.float32)
    cls = rng.randint(-1, c, n).astype(np.int32)
    binary = rng.randint(-1, 2, (n, c)).astype(np.int32)
    if ignored == "all":
        cls[:] = -1
        binary[:] = -1
    # float32 sums in another order: 1e-6 relative
    tol = dict(rtol=1e-6, atol=1e-7)
    for sigma in (1.0, 3.0):
        got = losses.fast_rcnn_loc_loss(t(loc), t(gt_loc), t(cls), sigma)
        want = jax_losses.fast_rcnn_loc_loss(loc, gt_loc, cls, sigma)
        np.testing.assert_allclose(float(got), float(want), **tol)
        w = (cls > 0).astype(np.float32)[:, None].repeat(4, 1)
        got = losses.smooth_l1_loss(t(loc), t(gt_loc), t(w), sigma)
        want = jax_losses.smooth_l1_loss(loc, gt_loc, w, sigma)
        np.testing.assert_allclose(float(got), float(want), **tol)
    got = losses.sigmoid_cross_entropy(t(logits), t(binary))
    want = jax_losses.sigmoid_cross_entropy(logits, binary)
    np.testing.assert_allclose(float(got), float(want), **tol)
    got = losses.softmax_cross_entropy(t(logits), t(cls))
    want = jax_losses.softmax_cross_entropy(logits, cls)
    np.testing.assert_allclose(float(got), float(want), **tol)
    if ignored == "all":
        assert float(got) == 0.0


# --------------------------------------------------------------------------
# K7: RoIAlign backward


@pytest.mark.parametrize("bin_stride,sampling_ratio",
                         [(1, 0), (2, 0), (1, 2), (2, 2)])
def test_roi_align_backward_matches_jax_vjp(bin_stride, sampling_ratio):
    rng = np.random.RandomState(2)
    n, h, w, c, r = 2, 9, 13, 6, 11
    feats = rng.randn(n, h, w, c).astype(np.float32)
    rois = np.stack([random_boxes(rng, r, h * 16, w * 16, min_size=2)
                     for _ in range(n)])
    # on and beyond the borders, the whole image, a zero-padded slot
    rois[:, :4] = [[-20, -20, 40, 40], [h * 16 - 30, w * 16 - 30,
                                        h * 16 + 30, w * 16 + 30],
                   [0, 0, h * 16, w * 16], [0, 0, 0, 0]]
    g = rng.randn(n, r, 7, 7, c).astype(np.float32)

    def fwd(f, b):
        return jax_roi_align_grouped(f, b, out_size=7, spatial_scale=1 / 16,
                                     sampling_ratio=sampling_ratio,
                                     bin_stride=bin_stride)

    _, vjp = jax.vjp(fwd, jnp.asarray(feats), jnp.asarray(rois))
    want_f, want_r = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    assert not want_r.any()  # stop_gradient on the rois

    args = (1 / 16, sampling_ratio, bin_stride)
    got = roi_align.roi_align_grouped_backward_plain(t(g), t(rois), (h, w),
                                                     *args).numpy()
    # float32 einsums in another order: 1e-5 of the largest value
    atol = 1e-5 * np.abs(want_f).max()
    np.testing.assert_allclose(got, want_f, rtol=1e-5, atol=atol)

    # the autograd Function (the port's path with gradients on)
    f = t(feats).requires_grad_(True)
    b = t(rois).requires_grad_(True)
    out = roi_align.roi_align_grouped(f, b, 7, *args)
    assert out.grad_fn is not None
    out.backward(t(g))
    assert b.grad is None
    np.testing.assert_allclose(f.grad.numpy(), want_f, rtol=1e-5, atol=atol)


# --------------------------------------------------------------------------
# K8: mask-target crop-resize


def near_tie_cells(masks, gt_index, rois, out_size):
    """(N, Q, out, out) bool: cells whose float64 interpolation is within
    1e-5 of the 0.5 threshold (where float32 rounding order decides)."""
    n, g, h, w = masks.shape
    out = np.zeros(gt_index.shape + (out_size, out_size), bool)
    for i in range(n):
        for q in range(gt_index.shape[1]):
            r = np.round(rois[i, q]).astype(np.int64)
            m = masks[i, gt_index[i, q]].astype(np.float64)

            def axis(a, b, size):
                c = max(b - a, 1)
                v = np.clip((np.arange(out_size) + .5) * c / out_size - .5,
                            0, c - 1) + a
                lo = np.floor(v).astype(int)
                return (np.clip(lo, 0, size - 1),
                        np.minimum(lo + 1, size - 1), v - np.clip(lo, 0,
                                                                  size - 1))

            y0, y1, ly = axis(r[0], r[2], h)
            x0, x1, lx = axis(r[1], r[3], w)
            v = (m[y0][:, x0] * np.outer(1 - ly, 1 - lx)
                 + m[y0][:, x1] * np.outer(1 - ly, lx)
                 + m[y1][:, x0] * np.outer(ly, 1 - lx)
                 + m[y1][:, x1] * np.outer(ly, lx))
            out[i, q] = np.abs(v - 0.5) < 1e-5
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_mask_crop_resize_plain_matches_jax(packed):
    rng = np.random.RandomState(3)
    n, g, h, w, q = 2, 4, 48, 64, 30
    masks = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1 = 2 * rng.randint(0, 12), 2 * rng.randint(0, 16)
            masks[i, k, y1:y1 + 2 * rng.randint(4, 12),
                  x1:x1 + 2 * rng.randint(4, 15)] = 1
            masks[i, k] ^= (rng.rand(h, w) < 0.05).astype(np.uint8)
    rois = np.stack([random_boxes(rng, q, h, w, min_size=1)
                     for _ in range(n)])
    # 28-pixel crops at 14: samples exactly midway between two rows
    rois[:, :4] = [[0, 0, 28, 28], [2, 4, 30, 32], [10.5, 11.5, 38.5, 25.5],
                   [5, 5, 5, 5]]
    gt_index = rng.randint(0, g, (n, q)).astype(np.int64)
    m = pack_mask_bits(masks) if packed else masks

    got = target_ops.mask_crop_resize(t(m), t(gt_index), t(rois), 14,
                                      packed).numpy()
    want = np.stack([np.asarray(jax_targets._crop_resize_masks_indexed(
        jnp.asarray(m[i]), jnp.asarray(gt_index[i]), jnp.asarray(rois[i]),
        14, packed=packed)) for i in range(n)])
    ties = near_tie_cells(masks, gt_index, rois, 14)
    assert ties.sum() > 50  # the fixture does build ties
    # Identical away from exact-0.5 ties; at ties the two may round their
    # sample coordinate differently (the JAX side documents 0.1% of cells
    # on tie-prone crops against cv2). Count them.
    diff = got != want
    assert not (diff & ~ties).any()
    assert diff.sum() <= 0.01 * ties.sum(), (diff.sum(), ties.sum())
    assert got.dtype == np.int32 and set(np.unique(got)) <= {0, 1}


# --------------------------------------------------------------------------
# K9 and the creators


def gt_fixture(rng, n, g, h, w):
    bbox = np.stack([random_boxes(rng, g, h, w, min_size=6)
                     for _ in range(n)])
    valid = np.ones((n, g), bool)
    valid[0, g - 1] = False
    valid[n - 1] = False  # an image with no valid gt
    bbox[0, 1] = bbox[0, 0]  # a duplicated gt: IoU ties across gts
    return bbox, valid


def test_anchor_targets_identical_to_jax():
    cfg = mask_rcnn.MaskRCNNConfig(n_fg_class=3, anchor_scales=(1.0, 2.0,
                                                                4.0))
    h, w = 96, 128
    anchors = mask_rcnn.make_anchors(cfg, h // 16, w // 16)
    rng = np.random.RandomState(4)
    n, g = 3, 5
    bbox, valid = gt_fixture(rng, n, g, h, w)
    bbox[1, 0] = anchors[100]  # an anchor equal to a gt: IoU 1
    acfg_j = jax_targets.AnchorTargetConfig(n_sample=64)
    acfg_t = targets.AnchorTargetConfig(n_sample=64)
    key = jax.random.PRNGKey(5)

    want_loc, want_label = jax.vmap(
        lambda k, b, v: jax_targets.anchor_targets(
            k, b, v, jnp.asarray(anchors), (h, w), acfg_j)
    )(jax.random.split(key, n), bbox, valid)
    got_loc, got_label = targets.anchor_targets(
        t(bbox), t(valid), t(anchors), (h, w), acfg_t,
        priorities=jax_priorities(key, n, len(anchors)))
    want_label = np.asarray(want_label)
    np.testing.assert_array_equal(got_label.numpy(), want_label)
    assert (want_label[0] == 1).any() and (want_label[1] == 1).any()
    assert not (want_label[2] == 1).any() and (want_label[2] == 0).any()
    # the same ops (a true division and a log): identical up to libm
    np.testing.assert_allclose(got_loc.numpy(), np.asarray(want_loc),
                               rtol=1e-6, atol=1e-6)

    # the pre-sampling labels of K9's plain version against the JAX rules
    argmax, label0 = target_ops.anchor_match_plain(
        t(anchors), t(bbox), t(valid), (h, w), 0.7, 0.3)
    sampled = want_label >= 0
    np.testing.assert_array_equal(label0.numpy()[sampled],
                                  want_label[sampled])


@pytest.mark.parametrize("packed", [False, True])
def test_proposal_targets_identical_to_jax(packed):
    rng = np.random.RandomState(6)
    n, g, h, w, p = 3, 4, 64, 96, 60
    bbox, valid = gt_fixture(rng, n, g, h, w)
    label = rng.randint(0, 5, (n, g)).astype(np.int32)
    # proposals: jittered copies of the gts (positives) and random boxes
    roi = np.stack([random_boxes(rng, p, h, w, min_size=4)
                    for _ in range(n)])
    roi[:, :16] = (bbox[:, rng.randint(0, g, 16)]
                   + rng.randn(n, 16, 4).astype(np.float32) * 2)
    roi_valid = rng.rand(n, p) > 0.1
    masks = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1, y2, x2 = np.round(bbox[i, k]).astype(int)
            masks[i, k, y1:y2, x1:x2] = 1
            masks[i, k, y1:y1 + 3, x1:x1 + 3] = 0
    m = pack_mask_bits(masks) if packed else masks
    pcfg_j = jax_targets.ProposalTargetConfig(n_sample=32)
    pcfg_t = targets.ProposalTargetConfig(n_sample=32)
    key = jax.random.PRNGKey(7)

    want = jax.vmap(
        lambda k, r, rv, b, lab, bv, mm: jax_targets.proposal_targets(
            k, r, rv, b, lab, bv, mm, pcfg_j, mask_packed=packed)
    )(jax.random.split(key, n), roi, roi_valid, bbox, label, valid, m)
    got = targets.proposal_targets(
        t(roi), t(roi_valid), t(bbox), t(label), t(valid), t(m), pcfg_t,
        mask_packed=packed, priorities=jax_priorities(key, n, p + g))
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[0], want[0])  # sample rois
    np.testing.assert_array_equal(got[2], want[2])  # labels
    np.testing.assert_array_equal(got[3], want[3])  # masks
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-5)
    assert (want[2][:2] > 0).any() and (want[3] >= 0).any()
    # the zero-gt image trains on background only
    assert (want[2][2] == 0).any() and not (want[2][2] > 0).any()


def test_creators_draw_from_a_generator():
    """Without priorities the creators sample from ``generator``: the same
    seed gives the same targets, and the samples respect the quotas."""
    rng = np.random.RandomState(8)
    n, g, h, w = 2, 3, 64, 96
    bbox, valid = gt_fixture(rng, n, g, h, w)
    cfg = mask_rcnn.MaskRCNNConfig(n_fg_class=3, anchor_scales=(1.0, 2.0))
    anchors = t(mask_rcnn.make_anchors(cfg, h // 16, w // 16))
    acfg = targets.AnchorTargetConfig(n_sample=32)
    outs = [targets.anchor_targets(
        t(bbox), t(valid), anchors, (h, w), acfg,
        generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(outs[0][1], outs[1][1])
    label = outs[0][1]
    assert ((label == 1).sum(-1) <= 16).all()
    assert ((label >= 0).sum(-1) <= 32).all()


# --------------------------------------------------------------------------
# The creators at their edge cases (tests/torch_target_cases.py), with
# given priorities


def inject_priorities(monkeypatch, rows):
    """Make the JAX creators sample by given priorities: one row per
    ``_sample_masked`` call, in call order (per image: positives, then
    negatives). The body is ``jax_targets._sample_masked`` with the
    priorities taken instead of drawn."""
    queue = [jnp.asarray(r) for r in rows]

    def sample(key, candidate_mask, k_static):
        priority = jnp.where(candidate_mask, queue.pop(0), -jnp.inf)
        k = min(k_static, candidate_mask.shape[0])
        top, idx = jax.lax.top_k(priority, k)
        return idx, jnp.isfinite(top)

    monkeypatch.setattr(jax_targets, "_sample_masked", sample)
    return queue


@pytest.mark.parametrize("case", CPU_CASES)
def test_anchor_targets_edge_cases_identical_to_jax(monkeypatch, case):
    c = anchor_case(case)
    n, ns = c["bbox"].shape[0], c["n_sample"]
    queue = inject_priorities(monkeypatch, [
        r for i in range(n) for r in (c["pri_pos"][i], c["pri_neg"][i])])
    jcfg = jax_targets.AnchorTargetConfig(n_sample=ns)
    want = [jax_targets.anchor_targets(
        jax.random.PRNGKey(0), c["bbox"][i], c["bbox_valid"][i],
        jnp.asarray(c["anchors"]), c["img_size"], jcfg) for i in range(n)]
    assert not queue
    want_loc = np.stack([np.asarray(x[0]) for x in want])
    want_label = np.stack([np.asarray(x[1]) for x in want])
    got_loc, got_label = targets.anchor_targets(
        t(c["bbox"]), t(c["bbox_valid"]), t(c["anchors"]), c["img_size"],
        targets.AnchorTargetConfig(n_sample=ns),
        priorities=(t(c["pri_pos"]), t(c["pri_neg"])))
    np.testing.assert_array_equal(got_label.numpy(), want_label)
    # the same ops (a true division and a log): identical up to libm
    np.testing.assert_allclose(got_loc.numpy(), want_loc, rtol=1e-6,
                               atol=1e-6)

    _, label0 = target_ops.anchor_match_plain(
        t(c["anchors"]), t(c["bbox"]), t(c["bbox_valid"]), c["img_size"],
        0.7, 0.3)
    label0 = label0.numpy()
    quota = ns // 2
    n_pos = np.minimum((label0 == 1).sum(1), quota)
    assert ((want_label == 1).sum(1) == n_pos).all()
    assert ((want_label == 0).sum(1)
            == np.minimum((label0 == 0).sum(1), ns - n_pos)).all()
    if case == "ties":  # equal keys straddle both cuts
        assert threshold_ties(c["pri_pos"], label0 == 1, quota)
        assert threshold_ties(c["pri_neg"], label0 == 0, ns - n_pos[0])
    if case == "few_pos":
        assert (0 < (label0 == 1).sum(1)).all()
        assert ((label0 == 1).sum(1) < quota).all()
    if case == "no_gt":
        assert not (want_label[0] == 1).any() and (want_label[0] == 0).any()
    if case == "small_pool":  # every candidate taken
        assert len(c["anchors"]) < ns
        np.testing.assert_array_equal(want_label, label0)
    if case == "g1":
        assert c["bbox"].shape[1] == 1 and (want_label == 1).any()


@pytest.mark.parametrize("case", CPU_CASES)
def test_proposal_targets_edge_cases_identical_to_jax(monkeypatch, case):
    c = proposal_case(case)
    n, ns = c["bbox"].shape[0], c["n_sample"]
    packed = CPU_CASES.index(case) % 2 == 0
    m = pack_mask_bits(c["masks"]) if packed else c["masks"]
    queue = inject_priorities(monkeypatch, [
        r for i in range(n) for r in (c["pri_pos"][i], c["pri_neg"][i])])
    jcfg = jax_targets.ProposalTargetConfig(n_sample=ns)
    want = [jax_targets.proposal_targets(
        jax.random.PRNGKey(0), c["roi"][i], c["roi_valid"][i], c["bbox"][i],
        c["label"][i], c["bbox_valid"][i], m[i], jcfg, mask_packed=packed)
        for i in range(n)]
    assert not queue
    want = [np.stack([np.asarray(x[k]) for x in want]) for k in range(4)]
    got = targets.proposal_targets(
        t(c["roi"]), t(c["roi_valid"]), t(c["bbox"]), t(c["label"]),
        t(c["bbox_valid"]), t(m), targets.ProposalTargetConfig(n_sample=ns),
        mask_packed=packed, priorities=(t(c["pri_pos"]), t(c["pri_neg"])))
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[0], want[0])  # sample rois
    np.testing.assert_array_equal(got[2], want[2])  # labels
    np.testing.assert_array_equal(got[3], want[3])  # masks
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-5)

    cand = torch.cat([t(c["roi"]), t(c["bbox"])], dim=1)
    cand_valid = torch.cat([t(c["roi_valid"]), t(c["bbox_valid"])], dim=1)
    _, pos, neg = target_ops.proposal_match_plain(
        cand, cand_valid, t(c["bbox"]), t(c["bbox_valid"]), 0.5, 0.5, 0.0)
    pos, neg = pos.numpy(), neg.numpy()
    quota = round(ns * 0.25)
    n_pos = (want[2] > 0).sum(1)
    assert (n_pos == np.minimum(pos.sum(1), quota)).all()
    assert (want[3][:, :, 0, 0] >= 0).sum(1).tolist() == n_pos.tolist()
    if case == "ties":
        assert threshold_ties(c["pri_pos"], pos, quota)
        assert threshold_ties(c["pri_neg"], neg, ns - n_pos[0])
    if case == "few_pos":
        assert (0 < n_pos).all() and (n_pos < quota).all()
    if case == "no_gt":  # background only
        assert not (want[2][0] > 0).any() and (want[2][0] == 0).any()
    if case == "small_pool":  # unfilled slots
        assert cand.shape[1] < ns and (want[2] == -1).any()
    if case == "g1":
        assert c["bbox"].shape[1] == 1 and (n_pos > 0).all()
