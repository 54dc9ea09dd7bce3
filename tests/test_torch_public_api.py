"""The port's twin of tests/test_public_api.py: the flat import surface of
each subpackage carries the JAX package's names, so migrating code keeps
its import sites.

Two surfaces map rather than copy:

- ``ops.roi_align`` is the module (the port's own code imports it as
  one); the flat RoIAlign is ``ops.roi_align.roi_align``.
- ``parallel``: the JAX package shards arrays over a ``jax.sharding``
  mesh; the port runs one process per device in the default
  ``torch.distributed`` process group. ``make_mesh`` -> ``init_distributed``
  (the group is the mesh: its ranks are the data axis);
  ``batch_sharding`` and ``shard_batch`` -> ``local_batch_slice`` (each
  rank holds its slice of the global batch, as ``TrainLoader(process_index,
  process_count)`` loads it); ``replicated`` -> ``broadcast_params`` and
  ``replicate_params`` (rank 0's params on every rank; one copy a device
  for sharded predict); ``make_parallel_train_step``,
  ``make_parallel_predict_step``, ``local_batch_slice`` and
  ``process_zero`` keep their names.
"""

import os
import os.path as osp
import subprocess
import sys
import warnings

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_ops_surface():
    from mask_rcnn_tpu_torch import ops

    for name in [
        "roi_pool", "crop_and_resize", "affine_channel",
        "fold_batch_norm", "nms_padded", "generate_anchor_base",
        "enumerate_shifted_anchors", "loc2bbox", "bbox2loc", "bbox_iou",
        "clip_boxes", "softmax_cross_entropy", "sigmoid_cross_entropy",
        "smooth_l1_loss", "roi_align_grouped", "init_affine_channel",
    ]:
        assert callable(getattr(ops, name)), name
    assert callable(ops.roi_align.roi_align)
    assert callable(ops.roi_align.roi_align_grouped)


def test_models_surface():
    from mask_rcnn_tpu_torch import models

    for name in [
        "MaskRCNNResNet", "MaskRCNNConfig", "init_params", "predict_step",
        "ProposalConfig", "AnchorTargetConfig", "ProposalTargetConfig",
        "anchor_targets", "proposal_targets", "train_loss",
    ]:
        assert getattr(models, name) is not None, name
    assert callable(models.MaskRCNNResNet.predict)
    assert callable(models.MaskRCNNResNet.predict_stream)


def test_data_surface():
    from mask_rcnn_tpu_torch import data

    for name in [
        "COCOInstanceSegmentationDataset",
        "VOC2012InstanceSegmentationDataset",
        "SBDInstanceSegmentationDataset", "VOCLikeDataset",
        "IndexingDataset", "MaskRcnnDataset", "MaskRCNNTransform",
        "TrainLoader", "pad_batch",
    ]:
        assert getattr(data, name) is not None, name
    for name in ("COCOInstanceSegmentationDataset",
                 "VOC2012InstanceSegmentationDataset",
                 "SBDInstanceSegmentationDataset"):
        assert callable(getattr(data, name).download), name


def test_utils_flat_surface_matches_reference():
    from mask_rcnn_tpu_torch import utils

    for name in [
        "git_hash", "batch", "eval_instseg_voc", "eval_instseg_coco",
        "get_bbox_overlap", "get_mask_overlap", "instance_boxes2label",
        "label2instance_boxes", "mask_to_bbox", "draw_instance_boxes",
        "draw_instance_bboxes", "visualize_instance_segmentation",
        "load_params", "save_params", "paste_masks",
    ]:
        assert callable(getattr(utils, name)), name


def test_engine_surface():
    from mask_rcnn_tpu_torch import engine
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
        VisReport,
    )
    from mask_rcnn_tpu_torch.engine.loop import train

    assert callable(train)
    assert InstanceSegmentationEvaluator is not None
    assert VisReport is not None
    for name in ["make_optimizer", "make_train_step", "step_lr_schedule",
                 "create_train_state", "TrainState", "trainable_mask"]:
        assert getattr(engine, name) is not None, name


def test_parallel_surface():
    """The JAX names, mapped to the process group's (module docstring)."""
    from mask_rcnn_tpu_torch import parallel

    mapping = {
        "make_mesh": "init_distributed",
        "make_parallel_train_step": "make_parallel_train_step",
        "batch_sharding": "local_batch_slice",
        "replicated": "broadcast_params",
        "shard_batch": "local_batch_slice",
        "local_batch_slice": "local_batch_slice",
        "process_zero": "process_zero",
    }
    for jax_name, name in mapping.items():
        assert callable(getattr(parallel, name)), (jax_name, name)
    for name in ("make_parallel_predict_step", "replicate_params"):
        assert callable(getattr(parallel, name)), name


def test_deprecated_alias_warns():
    from mask_rcnn_tpu_torch.utils import draw_instance_boxes

    img = np.zeros((8, 8, 3), np.uint8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = draw_instance_boxes(
            img, np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), 3
        )
    assert out.shape == img.shape
    assert any("deprecated" in str(x.message) for x in w)


def test_flat_surfaces_import_light():
    """Importing the flat surfaces imports neither cv2 nor jax and builds
    no native code: the host evaluator's C++ waits for its first use."""
    code = (
        "import sys\n"
        "import mask_rcnn_tpu_torch.utils, mask_rcnn_tpu_torch.ops\n"
        "import mask_rcnn_tpu_torch.models, mask_rcnn_tpu_torch.engine\n"
        "from mask_rcnn_tpu_torch.utils import native\n"
        "loaded = [m for m in ('cv2', 'PIL', 'yaml', 'scipy', 'jax',\n"
        "                      'mask_rcnn_tpu') if m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "assert native._lib is None and not native._tried\n"
        "print('light')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "light"
