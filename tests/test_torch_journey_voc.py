"""The port's VOC user journey on the CPU: the VOC rehearsal (the SBD train,
evaluate, demo and summarize drivers, each in its own process, on the
synthetic SBD root, whose JPEGs need cv2 or PIL)."""

import os
import os.path as osp

import pytest

from mask_rcnn_tpu_torch.data._image import jpeg_decoder, read_rgb
from mask_rcnn_tpu_torch.examples import check_voc_rehearsal

# As tests/test_torch_journey.py: 2 steps with one evaluation in place of
# the JAX rehearsal's --max-epoch 2 on the CPU.
TINY_ARGS = ["--min-size", "64", "--max-size", "96", "--max-epoch", "0.25",
             "--eval-interval-epochs", "0.25", "--n-val", "1",
             "--min-map", "-1", "--device", "cpu"]


def test_voc_rehearsal_artifacts(tmp_path):
    if jpeg_decoder() is None:
        pytest.skip("the SBD root's JPEGs need cv2 or PIL")
    summary = check_voc_rehearsal.main(TINY_ARGS + ["--workdir",
                                                    str(tmp_path)])
    assert summary["check"] == "voc_rehearsal" and summary["steps"] == 2
    log_dir = summary["log_dir"]
    assert {"params.yaml", "log", "snapshot_model.npz",
            "snapshot_model.npz.eval_result.yaml",
            "visualizations"} <= set(os.listdir(log_dir))
    assert sorted(os.listdir(osp.join(log_dir, "visualizations"))) == [
        "iteration=00000000.jpg", "iteration=00000002.jpg", "latest.jpg"]
    demo_out = os.listdir(tmp_path / "demo_out")
    assert len(demo_out) == 1 and demo_out[0].endswith(".jpg")
    # one val image at 96x128: one (GT | prediction) panel
    tile = read_rgb(osp.join(log_dir, "visualizations", "latest.jpg"))
    assert tile.shape == (96, 2 * 128, 3)
