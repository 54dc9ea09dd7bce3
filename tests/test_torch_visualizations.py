"""The port's drawing (``utils/visualizations.py``) and visualization report
(``engine/evaluator.py::VisReport``, ``train(vis_report=)``) against the
JAX package's on the CPU. Both draw with this machine's one cv2, so every
picture must be bit-identical; the report's files must carry the same
names. Last, the evaluate driver of each package on one port-written log
dir: the same report, and visualization tiles that differ on at most 0.5%
of pixels (the two models' float32 predictions round apart)."""

import functools
import glob
import json
import os
import os.path as osp
import runpy
import shutil
import subprocess
import sys
import warnings

import cv2
import numpy as np
import pytest
import torch
import yaml

from mask_rcnn_tpu.engine.evaluator import VisReport as JaxVisReport
from mask_rcnn_tpu.utils import visualizations as jax_vis
from mask_rcnn_tpu_torch.engine import loop, trainer
from mask_rcnn_tpu_torch.data._image import read_rgb
from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_coco_root
from mask_rcnn_tpu_torch.engine.evaluator import (
    InstanceSegmentationEvaluator,
    VisReport,
)
from mask_rcnn_tpu_torch.examples.coco import evaluate as coco_evaluate
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, init_params
from mask_rcnn_tpu_torch.models.targets import (
    AnchorTargetConfig,
    ProposalTargetConfig,
)
from mask_rcnn_tpu_torch.utils import visualizations as vis
from mask_rcnn_tpu_torch.utils.checkpoint import save_params
from mask_rcnn_tpu_torch.utils.logging import dump_params
from tests.test_engine import make_dataset
from tests.test_torch_loop import make_loader, tiny_cfg

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def random_instances(rng, n, h, w, n_class):
    """``n`` seeded boxes (y1, x1, y2, x2) inside (h, w), labels, scores
    and the boxes' filled masks."""
    y1 = rng.uniform(0, h - 8, n)
    x1 = rng.uniform(0, w - 8, n)
    y2 = np.minimum(y1 + rng.uniform(4, h / 2, n), h)
    x2 = np.minimum(x1 + rng.uniform(4, w / 2, n), w)
    bboxes = np.stack([y1, x1, y2, x2], 1).astype(np.float32)
    labels = rng.randint(0, n_class, n).astype(np.int32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    masks = np.zeros((n, h, w), bool)
    for i, (a, b, c, d) in enumerate(bboxes.astype(int)):
        masks[i, a:c, b:d] = True
        masks[i, a:(a + c) // 2, b:(b + d) // 2] = False  # a notch
    return bboxes, labels, scores, masks


def test_label_colormap_matches_jax():
    for n in (1, 21, 256, 300):
        got = vis.label_colormap(n)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_vis.label_colormap(n))


@pytest.mark.parametrize("case", ["plain", "masks", "scores", "captions",
                                  "masks_scores", "zero_boxes",
                                  "many_classes"])
def test_draw_instance_bboxes_matches_jax(case):
    rng = np.random.RandomState(len(case))
    h, w, n_class = 90, 120, 300 if case == "many_classes" else 5
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    n = 0 if case == "zero_boxes" else 6
    bboxes, labels, scores, masks = random_instances(rng, n, h, w, n_class)
    kw = {}
    if "masks" in case or case in ("zero_boxes", "many_classes"):
        kw["masks"] = masks
    if "scores" in case:
        kw["scores"] = scores
    if case == "captions":
        kw["captions"] = [f"obj {i}" for i in range(n)]
    got = vis.draw_instance_bboxes(img, bboxes, labels, n_class, **kw)
    want = jax_vis.draw_instance_bboxes(img, bboxes, labels, n_class, **kw)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    if n:
        assert (got != img).any()


@pytest.mark.parametrize("tile_shape", [None, (1, 2), (3, 1)])
def test_get_tile_image_matches_jax(tile_shape):
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((20, 30), (25, 18), (12, 40))]
    if tile_shape == (1, 2):
        imgs = imgs[:2]
    got = vis.get_tile_image(imgs, tile_shape)
    np.testing.assert_array_equal(got, jax_vis.get_tile_image(imgs,
                                                              tile_shape))


def test_visualize_instance_segmentation_matches_jax():
    rng = np.random.RandomState(5)
    h, w = 64, 80
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    gt = random_instances(rng, 3, h, w, 4)
    pred = random_instances(rng, 5, h, w, 4)
    args = (img, gt[0], gt[1], gt[3], pred[0], pred[1], pred[3], pred[2])
    got = vis.visualize_instance_segmentation(*args, n_class=4)
    assert got.shape == (h, 2 * w, 3)
    np.testing.assert_array_equal(
        got, jax_vis.visualize_instance_segmentation(*args, n_class=4))


def test_draw_instance_boxes_warns_and_matches_jax():
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    bboxes, labels, _, masks = random_instances(rng, 2, 40, 50, 3)
    outs = []
    for fn in (vis.draw_instance_boxes, jax_vis.draw_instance_boxes):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            outs.append(fn(img, bboxes, labels, 3, masks=masks,
                           captions=["a", "b"]))
        assert any("deprecated" in str(x.message) for x in w)
    np.testing.assert_array_equal(outs[0], outs[1])


class StubModel:
    """A model whose ``predict`` returns fixed, seeded detections for each
    image (in call order), whatever its pixels."""

    def __init__(self, h, w, seed=0):
        rng = np.random.RandomState(seed)
        self.preds = []
        for _ in range(8):
            bb, lb, sc, mk = random_instances(rng, 5, h, w, 1)
            self.preds.append((bb, mk, lb, sc))
        self.calls = 0

    def predict(self, imgs):
        assert len(imgs) == 1 and imgs[0].dtype == np.float32
        bb, mk, lb, sc = self.preds[self.calls % len(self.preds)]
        self.calls += 1
        return [bb], [mk], [lb], [sc]


@pytest.mark.parametrize("indices", [(0, 1, 2, 3, 4, 5, 6, 7, 8), (2, 0)])
def test_vis_report_matches_jax(tmp_path, indices):
    """Both packages' reports, on the same dataset and the same stub
    predictions: identical tiles, the same file names, the same bytes."""
    ds = make_dataset(n=5, h=48, w=64)
    outs = {}
    for name, cls in (("port", VisReport), ("jax", JaxVisReport)):
        out = str(tmp_path / name)
        report = cls(ds, ds.class_names, out, indices=indices)
        assert report.score_thresh == 0.7
        assert report.indices == [i for i in indices if i < 5]
        tile = report(StubModel(48, 64), iteration=1234)
        files = sorted(os.listdir(osp.join(out, "visualizations")))
        blobs = {f: open(osp.join(out, "visualizations", f), "rb").read()
                 for f in files}
        outs[name] = (tile, files, blobs)
    (tile, files, blobs), (jtile, jfiles, jblobs) = outs["port"], outs["jax"]
    np.testing.assert_array_equal(tile, jtile)
    n = len([i for i in indices if i < 5])
    cols = int(np.ceil(np.sqrt(n)))
    assert tile.shape == (int(np.ceil(n / cols)) * 48, cols * 2 * 64, 3)
    assert files == jfiles == ["iteration=00001234.jpg", "latest.jpg"]
    assert blobs == jblobs


def test_vis_report_without_cv2_or_pil_raises():
    """The constructor imports the drawing's cv2: without it (and without
    PIL) a training run fails before its first step."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "from mask_rcnn_tpu_torch.engine.evaluator import VisReport\n"
        "try:\n"
        "    VisReport([], ['a'], 'unused')\n"
        "except ImportError as e:\n"
        "    assert 'cv2' in str(e), e\n"
        "    print('raised')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"


def test_train_writes_a_tile_each_evaluation(tmp_path, monkeypatch):
    """``train(vis_report=)`` on the CPU at a tiny configuration: a tile at
    each evaluation (and ``latest.jpg``), drawn at the report's threshold,
    and the evaluation reports equal a run without the report (the
    evaluation's 0.05 threshold is restored)."""
    monkeypatch.setattr(loop, "make_train_step", functools.partial(
        trainer.make_train_step,
        proposal_cfg=ProposalTargetConfig(n_sample=16),
        anchor_cfg=AnchorTargetConfig(n_sample=64)))
    ds = make_dataset()
    seen = []

    class Recording(VisReport):
        def __call__(self, model, iteration=0):
            seen.append((iteration, model.score_thresh))
            return super().__call__(model, iteration)

    reports = {}
    for name in ("plain", "vis"):
        out = str(tmp_path / name)
        evaluator = InstanceSegmentationEvaluator(ds, ds.class_names,
                                                  kind="voc", max_examples=2)
        report = (Recording(ds, ds.class_names, out, indices=(0, 1))
                  if name == "vis" else None)
        result = loop.train(tiny_cfg(), make_loader(ds), out, max_epoch=1.0,
                            evaluator=evaluator, vis_report=report,
                            eval_interval_epochs=0.5, log_interval=5,
                            device="cpu")
        assert result["iterations"] == 2
        with open(osp.join(out, "log")) as f:
            reports[name] = [e for e in json.load(f)
                             if "validation/main/map" in e]
    assert [e["iteration"] for e in reports["vis"]] == [1, 2]
    assert reports["vis"] == reports["plain"]
    assert seen == [(1, 0.7), (2, 0.7)]
    files = sorted(os.listdir(tmp_path / "vis" / "visualizations"))
    assert files == ["iteration=00000001.jpg", "iteration=00000002.jpg",
                     "latest.jpg"]
    assert not osp.exists(tmp_path / "plain" / "visualizations")


def test_evaluate_drivers_agree_with_jax(tmp_path, capsys):
    """The COCO evaluate driver of each package, float32 and
    ``--strict-parity``, on copies of one log dir the port wrote (seeded
    weights at a small configuration) over a synthetic minival image: the
    reports agree (pytest.approx, the tolerance tests/test_torch_drivers.py
    holds the port's report to) and the ``latest.jpg`` tiles differ on at
    most 0.5% of pixels. The class-score weights are scaled up so that
    the seeded model's scores spread: 20 detections pass the report's 0.7,
    at least 8e-4 apart, so both prediction panels draw the same boxes
    and masks."""
    # one image: one batch shape, so the JAX model compiles once
    root = make_synthetic_coco_root(str(tmp_path / "COCO"), n_train=1,
                                    n_valminusminival=1, n_minival=1)
    mc = dict(n_fg_class=3, n_layers=50, min_size=64, max_size=96,
              anchor_scales=(1.0, 2.0))
    dirs = {n: str(tmp_path / n) for n in ("port", "jax")}
    params = init_params(MaskRCNNConfig(**mc),
                         torch.Generator().manual_seed(0), "cpu")
    params["head"]["score"]["W"] *= 1000.0
    os.makedirs(dirs["port"])
    save_params(osp.join(dirs["port"], "snapshot_model.npz"), params)
    dump_params(dirs["port"], {"dataset": "coco", "model_config": mc})
    shutil.copytree(dirs["port"], dirs["jax"])
    old_env, old_path, old_argv = (os.environ.get("COCO_ROOT"),
                                   list(sys.path), sys.argv)
    os.environ["COCO_ROOT"] = root
    try:
        port = coco_evaluate.main([dirs["port"], "--strict-parity",
                                   "--device", "cpu"])
        script = osp.join(REPO, "examples", "coco", "evaluate.py")
        sys.argv = [script, dirs["jax"], "--strict-parity"]
        runpy.run_path(script, run_name="__main__")
    finally:
        sys.path[:], sys.argv = old_path, old_argv
        if old_env is None:
            os.environ.pop("COCO_ROOT")
        else:
            os.environ["COCO_ROOT"] = old_env
    with open(osp.join(dirs["jax"],
                       "snapshot_model.npz.eval_result.yaml")) as f:
        jax_report = yaml.safe_load(f)
    assert set(port) == set(jax_report)
    for k, v in jax_report.items():
        assert port[k] == pytest.approx(v, nan_ok=True), k
    tiles = [cv2.imread(osp.join(d, "visualizations", "latest.jpg"))
             for d in dirs.values()]
    # one minival image at 96x128: one (GT | prediction) panel
    assert tiles[0].shape == tiles[1].shape == (96, 2 * 128, 3)
    share = float((tiles[0] != tiles[1]).any(axis=2).mean())
    print(f"latest.jpg: {share:.4%} of pixels differ (port vs JAX)")
    assert share <= 0.005
    # the prediction panels are drawn over, not the bare image
    img = read_rgb(sorted(glob.glob(osp.join(root, "val2014", "*.png")))[0])
    for name, tile in zip(dirs, tiles):
        drawn = float((np.abs(tile[:, 128:, ::-1].astype(np.int32) - img)
                       .max(axis=2) > 48).mean())
        print(f"{name}: {drawn:.2%} of the prediction panel drawn over")
        assert drawn > 0.05, name
