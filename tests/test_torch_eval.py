"""The port's evaluation (``utils/cocoeval.py``, ``utils/voc_eval.py``,
``engine/evaluator.py``, ``MaskRCNNResNet.predict_collect_raw``) against the
JAX package's on the same seeded detections and ground truth: every entry of
``results()`` to 1e-12, through the native (C++) matcher and through the
numpy one, from pasted masks (``add``) and box-locally (``add_boxlocal``);
the evaluator's reports with stub models; and the port's model against the
JAX model through both evaluators.

The box-local masks go through a bilinear resize: the port's is cv2's plain
(non-IPP) path, so the JAX side runs with ``cv2.setUseOptimized(False)``."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.engine import evaluator as jax_evaluator
from mask_rcnn_tpu.models import api as jax_api
from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import rpn as jax_rpn
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu.utils import cocoeval as jax_cocoeval
from mask_rcnn_tpu.utils import masks as jax_masks
from mask_rcnn_tpu.utils import native as jax_native
from mask_rcnn_tpu.utils import voc_eval as jax_voc
from mask_rcnn_tpu_torch.engine import evaluator
from mask_rcnn_tpu_torch.models import api, mask_rcnn, rpn
from mask_rcnn_tpu_torch.utils import checkpoint, cocoeval, native, voc_eval
from mask_rcnn_tpu_torch.utils import masks as port_masks
from tests.test_torch_models import proposal_kwargs, tiny_kwargs


@pytest.fixture(autouse=True)
def plain_cv2():
    was = cv2.useOptimized()
    cv2.setUseOptimized(False)
    yield
    cv2.setUseOptimized(was)


@pytest.fixture(params=["native", "numpy"])
def matcher(request, monkeypatch):
    """Both packages' native matcher, or both packages' numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, "g++ build of cocoeval.cpp"
    return request.param


def image_record(rng, h=40, w=52, n_class=3):
    """One image: gts (masks, labels, crowds, areas) and detections (boxes,
    (14, 14) probabilities, labels, scores) near the gts, some far off,
    some with tied scores."""
    g = rng.randint(1, 5)
    gt_masks = np.zeros((g, h, w), bool)
    gt_boxes = []
    for k in range(g):
        y1, x1 = rng.randint(0, h - 12), rng.randint(0, w - 12)
        y2, x2 = y1 + rng.randint(6, h - y1), x1 + rng.randint(6, w - x1)
        gt_masks[k, y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.2
        gt_boxes.append((y1, x1, y2, x2))
    gt_labels = rng.randint(0, n_class, g).astype(np.int32)
    crowds = rng.rand(g) < 0.25
    areas = gt_masks.sum(axis=(1, 2)).astype(np.float32) * \
        rng.uniform(0.5, 30, g).astype(np.float32)
    d = rng.randint(0, 7)
    boxes = []
    for k in range(d):
        if k < g and rng.rand() < 0.7:
            b = np.asarray(gt_boxes[k], np.float32) + rng.randn(4) * 2
        else:
            y1, x1 = rng.uniform(-4, h - 4), rng.uniform(-4, w - 4)
            b = np.asarray((y1, x1, y1 + rng.uniform(3, h),
                            x1 + rng.uniform(3, w)))
        boxes.append(b)
    boxes = np.clip(np.asarray(boxes, np.float32).reshape(d, 4), 0,
                    [h, w, h, w]).astype(np.float32)
    probs = rng.rand(d, 14, 14).astype(np.float32)
    labels = np.where(np.arange(d) < g, gt_labels[:min(d, g)].tolist()
                      + [0] * max(d - g, 0), rng.randint(0, n_class, d))
    labels = np.asarray(labels, np.int32)[:d]
    scores = np.round(rng.rand(d), 1).astype(np.float32)  # ties
    return dict(size=(h, w), gt_masks=gt_masks, gt_labels=gt_labels,
                crowds=crowds, areas=areas, boxes=boxes, probs=probs,
                labels=labels, scores=scores)


def records(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return [image_record(rng) for _ in range(n)]


def assert_results_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "class_ids":
            assert list(g) == list(w)
            continue
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=1e-12, err_msg=k)


def feed(ev, recs, route, kind):
    for r in recs:
        if route == "add":
            masks = port_masks.paste_masks(r["boxes"], r["probs"], *r["size"])
            extras = (r["crowds"], r["areas"]) if kind == "coco" else ()
            ev.add(masks, r["labels"], r["scores"], r["gt_masks"],
                   r["gt_labels"], *extras)
        else:
            extras = (r["crowds"], r["areas"]) if kind == "coco" \
                else (r["crowds"],)  # VOC: the flags as difficult
            ev.add_boxlocal(r["boxes"], r["probs"], r["labels"], r["scores"],
                            r["size"], r["gt_masks"], r["gt_labels"],
                            *extras)


def test_boxlocal_masks_match_jax():
    for r in records(seed=9):
        got = port_masks.boxlocal_masks(r["boxes"], r["probs"], *r["size"])
        want = jax_masks.boxlocal_masks(r["boxes"], r["probs"], *r["size"])
        for (a, ay, ax), (b, by, bx) in zip(got, want):
            assert (ay, ax) == (by, bx)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["add", "add_boxlocal"])
def test_coco_evaluation_matches_jax(matcher, route):
    recs = records(seed=1)
    mine = cocoeval.COCOEvaluation("segm")
    theirs = jax_cocoeval.COCOEvaluation("segm")
    feed(mine, recs, route, "coco")
    feed(theirs, recs, route, "coco")
    want = theirs.results()
    assert np.isfinite(want["map/iou=0.50:0.95/area=all/maxDets=100"])
    assert_results_equal(mine.results(), want)


@pytest.mark.parametrize("route", ["add", "add_boxlocal"])
@pytest.mark.parametrize("use_07", [False, True])
def test_voc_evaluation_matches_jax(matcher, route, use_07):
    recs = records(seed=2)
    mine = voc_eval.VOCEvaluation(use_07_metric=use_07)
    theirs = jax_voc.VOCEvaluation(use_07_metric=use_07)
    feed(mine, recs, route, "voc")
    feed(theirs, recs, route, "voc")
    want = theirs.results()
    assert np.isfinite(want["map"])
    assert_results_equal(mine.results(), want)


class StubDataset:
    """Examples (img, bboxes, labels, masks, crowds, areas) of
    :func:`image_record`."""

    return_crowd = True
    return_area = True

    def __init__(self, recs):
        self.recs = recs

    def __len__(self):
        return len(self.recs)

    def __getitem__(self, i):
        r = self.recs[i]
        h, w = r["size"]
        img = np.full((h, w, 3), i, np.uint8)  # the stub reads i back
        return (img, np.zeros((len(r["gt_labels"]), 4), np.float32),
                r["gt_labels"], r["gt_masks"].astype(np.int32), r["crowds"],
                r["areas"])


class PastingStub:
    """Fixed outputs through predict_submit/predict_collect (full-image
    masks pasted by the port's paste, the same arrays for both packages)."""

    def __init__(self, recs):
        self.recs = recs

    def predict_submit(self, imgs):
        return [self.recs[int(im[0, 0, 0])] for im in imgs]

    def predict_collect(self, handle):
        out = ([], [], [], [])
        for r in handle:
            out[0].append(r["boxes"])
            out[1].append(port_masks.paste_masks(r["boxes"], r["probs"],
                                                 *r["size"]))
            out[2].append(r["labels"])
            out[3].append(r["scores"])
        return out


class RawStub(PastingStub):
    """Also predict_collect_raw: each evaluator takes the box-local route
    and its own package's box-local masks."""

    def predict_collect_raw(self, handle):
        return ([r["boxes"] for r in handle], [r["probs"] for r in handle],
                [r["labels"] for r in handle], [r["scores"] for r in handle],
                [r["size"] for r in handle])


@pytest.mark.parametrize("stub", [PastingStub, RawStub])
@pytest.mark.parametrize("kind", ["coco", "voc"])
def test_evaluator_reports_match_jax(stub, kind):
    recs = records(seed=3, n=5)
    ds = StubDataset(recs)
    names = ["a", "b", "c"]
    got = evaluator.InstanceSegmentationEvaluator(
        ds, names, kind=kind, batch_size=2)(stub(recs))
    want = jax_evaluator.InstanceSegmentationEvaluator(
        ds, names, kind=kind, batch_size=2)(stub(recs))
    assert "validation/main/map" in want
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_evaluator_refuses_multi_process_pooling():
    """``pool_detections`` pools across processes; in one process it is
    accepted and does nothing (as in the JAX package): the unpooled
    report."""
    recs = records(seed=3, n=5)
    ds = StubDataset(recs)
    names = ["a", "b", "c"]
    for kind in ("coco", "voc"):
        want = evaluator.InstanceSegmentationEvaluator(
            ds, names, kind=kind, batch_size=2)(RawStub(recs))
        got = evaluator.InstanceSegmentationEvaluator(
            ds, names, kind=kind, batch_size=2, pool_detections=True)(
                RawStub(recs))
        assert "validation/main/map" in want
        assert got == want


def model_dataset(jmodel):
    """4 images of 64x96 (scale 1 at min 64 / max 96) whose ground truth is
    the JAX model's own 3 best detections with a non-empty mask: a metric
    far from 0, which any difference between the two packages'
    detections, masks or matching would move."""
    rng = np.random.RandomState(11)
    recs = []
    for _ in range(4):
        img = rng.randint(0, 255, (64, 96, 3)).astype(np.uint8)
        _, masks, labels, _ = jmodel.predict(
            [img.transpose(2, 0, 1).astype(np.float32)])
        keep = [k for k in range(len(labels[0])) if masks[0][k].any()][:3]
        assert len(keep) == 3
        recs.append((img, np.zeros((len(keep), 4), np.float32),
                     labels[0][keep], masks[0][keep].astype(np.int32)))

    class DS:
        def __len__(self):
            return len(recs)

        def __getitem__(self, i):
            return recs[i]

    return DS()


@pytest.fixture(scope="module")
def both_models():
    kw = tiny_kwargs()
    jcfg = jax_mrcnn.MaskRCNNConfig(
        proposal=jax_rpn.ProposalConfig(**proposal_kwargs()), **kw)
    tcfg = mask_rcnn.MaskRCNNConfig(
        proposal=rpn.ProposalConfig(**proposal_kwargs()), **kw)
    # the port's seeded params, carried to the JAX layout (exact); the mask
    # logits' bias lifted so that random weights paste non-empty masks
    tparams = mask_rcnn.init_params(tcfg, torch.Generator().manual_seed(0))
    tparams["head"]["mask"]["b"] += 1.0
    jparams = jax.tree.map(jnp.asarray, jax_ckpt.unflatten_params(
        checkpoint.params_to_numpy(tparams)))
    jmodel = jax_api.MaskRCNNResNet.from_config(jcfg, jparams)
    tmodel = api.MaskRCNNResNet.from_config(tcfg, tparams, device="cpu")
    for m in (jmodel, tmodel):
        m.score_thresh = 0.0
    return jmodel, tmodel, model_dataset(jmodel)


@pytest.mark.parametrize("kind", ["coco", "voc"])
def test_model_map_matches_jax(both_models, kind):
    """The port's model (CPU, params carried across) and the JAX model give
    the same mAP through the two evaluators at ``score_thresh=0``."""
    jmodel, tmodel, ds = both_models
    names = ["a", "b", "c"]
    want = jax_evaluator.InstanceSegmentationEvaluator(
        ds, names, kind=kind, batch_size=2)(jmodel)
    got = evaluator.InstanceSegmentationEvaluator(
        ds, names, kind=kind, batch_size=2)(tmodel)
    assert got.keys() == want.keys()
    assert want["validation/main/map"] > 0.3
    # predict agrees to ~1e-5 (tests/test_torch_models.py), far from any
    # IoU threshold or score tie at this seed: the reports are equal
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    handle = tmodel.predict_submit([ds[0][0].transpose(2, 0, 1)
                                    .astype(np.float32)])
    boxes, probs, labels, scores, sizes = tmodel.predict_collect_raw(handle)
    assert len(boxes[0]) == tmodel.config.detections_per_im
    assert probs[0].shape == (len(boxes[0]), 14, 14)
    assert sizes == [(64, 96)]
