"""The port's user journey on the CPU, as a whole: the COCO rehearsal (the
train, evaluate, demo and summarize drivers, each in its own process, on
the synthetic COCO root) and the overfit check's function for a few
steps. The VOC rehearsal is ``tests/test_torch_journey_voc.py``; the two
packages' evaluate drivers on one log dir are held against each other in
``tests/test_torch_visualizations.py``."""

import json
import os
import os.path as osp

import cv2
import numpy as np
import pytest

from mask_rcnn_tpu_torch.examples import check_coco_rehearsal
from mask_rcnn_tpu_torch.examples.check_train_overfit import run_overfit

# The JAX rehearsal's CPU flags are --max-epoch 2 (20 steps): on this CPU a
# full-width R-50 step takes ~5 s and a prediction of 1000 rois ~3 s, so
# the journey here trains 2 steps with one evaluation, on 1 minival image.
TINY_ARGS = ["--min-size", "64", "--max-size", "96", "--max-epoch", "0.2",
             "--eval-interval-epochs", "0.2", "--n-val", "1",
             "--min-map", "-1", "--device", "cpu"]


@pytest.fixture(scope="module")
def coco_journey(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("coco_rehearsal"))
    summary = check_coco_rehearsal.main(TINY_ARGS + ["--workdir", workdir])
    return workdir, summary


def test_coco_rehearsal_artifacts(coco_journey):
    workdir, summary = coco_journey
    assert summary["check"] == "coco_rehearsal" and summary["steps"] == 2
    log_dir = summary["log_dir"]
    assert osp.dirname(log_dir) == osp.join(workdir, "logs")
    files = set(os.listdir(log_dir))
    assert {"params.yaml", "log", "snapshot_model.npz",
            "snapshot_model.npz.eval_result.yaml", "visualizations"} <= files
    assert sorted(os.listdir(osp.join(log_dir, "visualizations"))) == [
        "iteration=00000000.jpg", "iteration=00000002.jpg", "latest.jpg"]
    with open(osp.join(log_dir, "snapshot_model.npz.eval_result.yaml")) as f:
        result = json.load(f)
    assert result["validation/main/map@0.5"] == summary["map@0.5"]
    demo_out = os.listdir(osp.join(workdir, "demo_out"))
    assert len(demo_out) == 1 and demo_out[0].startswith("000_")
    # one minival image at 96x128: one (GT | prediction) panel
    tile = cv2.imread(osp.join(log_dir, "visualizations", "latest.jpg"))
    assert tile.shape == (96, 2 * 128, 3)


def test_overfit_function_runs_on_the_cpu(capsys):
    """The overfit check at its own configuration for 3 steps: finite
    losses, printed at each step."""
    out = run_overfit(steps=3, device="cpu", log_every=1)
    assert [it for it, _ in out["losses"]] == [0, 1, 2]
    for _, m in out["losses"]:
        assert all(np.isfinite(v) for v in m.values()), m
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("it ")]
    assert len(printed) == 3
    assert out["first"] == out["losses"][0][1]["loss"]
    assert out["seconds"] > 0
    bb, lb, sc = out["detections"]
    assert bb.shape == (len(lb), 4) and (sc >= 0.3).all()
