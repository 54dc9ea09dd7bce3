"""The port's drivers on the CPU: rebuilding a model from a log dir (a twin
of tests/test_log_dir_rebuild.py), the COCO train and evaluate drivers on
a small synthetic root with ImageNet weights from ``'auto'``, the JAX
package reading the log dir the port wrote, and the import boundary of
every port module."""

import json
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_coco_root
from mask_rcnn_tpu_torch.examples import log_dir, train_common
from mask_rcnn_tpu_torch.examples.coco import evaluate as coco_evaluate
from mask_rcnn_tpu_torch.examples.coco import train as coco_train
from mask_rcnn_tpu_torch.models import api
from mask_rcnn_tpu_torch.utils.detectron_import import import_imagenet_npz
from tests.torch_import_cases import write_imagenet_npz

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _capture_build(monkeypatch, tmp_path, params_yaml, as_json=False):
    with open(osp.join(str(tmp_path), "params.yaml"), "w") as f:
        if as_json:
            json.dump(params_yaml, f)
        else:
            yaml.safe_dump(params_yaml, f)
    captured = {}

    def fake_model(**kwargs):
        captured.update(kwargs)
        return "model"

    monkeypatch.setattr(api, "MaskRCNNResNet", fake_model)
    model, loaded = log_dir.build_model_from_log_dir(str(tmp_path),
                                                     device="cpu")
    assert model == "model" and loaded == params_yaml
    assert captured.pop("device") == "cpu"
    return captured


@pytest.mark.parametrize("as_json", [False, True])
def test_reference_flat_params_yaml_resnet101(monkeypatch, tmp_path,
                                              as_json):
    captured = _capture_build(monkeypatch, tmp_path, {
        # the reference's flat keys (no model_config dict)
        "model": "resnet101",
        "dataset": "voc",
        "class_names": [f"c{i}" for i in range(20)],
        "min_size": 600,
        "max_size": 1000,
        "anchor_scales": [4, 8, 16, 32],
        "roi_size": 14,
        "pooling_func": "align",
    }, as_json)
    assert captured == dict(
        n_layers=101, n_fg_class=20, min_size=600, max_size=1000,
        anchor_scales=(4, 8, 16, 32), roi_size=14, pooling_func="align",
        pretrained_model=osp.join(str(tmp_path), "snapshot_model.npz"))


def test_reference_flat_params_unknown_model_rejected(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="resnet152"):
        _capture_build(monkeypatch, tmp_path, {
            "model": "resnet152", "dataset": "voc",
            "class_names": [f"c{i}" for i in range(20)]})


def test_native_model_config_mean_restored(monkeypatch, tmp_path):
    mean = [122.7717, 115.9465, 102.9801]
    captured = _capture_build(monkeypatch, tmp_path, {
        "dataset": "coco",
        "model_config": {"n_fg_class": 80, "n_layers": 50, "min_size": 800,
                         "max_size": 1333,
                         "anchor_scales": [2, 4, 8, 16, 32], "roi_size": 14,
                         "mean": mean, "pooling": "align"},
    }, as_json=True)
    assert captured["mean"] == tuple(mean)
    assert captured["n_layers"] == 50 and captured["min_size"] == 800


def test_train_flags_reject_multi_node(monkeypatch):
    """``--multi-node`` parses; outside torchrun's environment
    ``train_common.train`` fails before it builds anything, naming
    torchrun."""
    args = train_common.parse_args({"max_epoch": 3.0}, [])
    assert args.device == "cuda" and args.max_epoch == 3.0
    assert not args.multi_node
    args = train_common.parse_args({}, ["--multi-node", "--device", "cpu"])
    assert args.multi_node
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "MASK_RCNN_TORCH_INIT_METHOD"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        train_common.train(args, None, None, ["a"], "coco", 64, 64, (1,))


@pytest.fixture(scope="module")
def coco_run(tmp_path_factory):
    """The COCO train driver for 2 steps (1 + 1 images at batch 1, one
    evaluation) from ImageNet weights found by 'auto', then the evaluate
    driver on its log dir, all on the CPU at min 64 / max 96."""
    base = tmp_path_factory.mktemp("coco_run")
    root = make_synthetic_coco_root(str(base / "coco"), n_train=1,
                                    n_valminusminival=1, n_minival=2,
                                    height=96, width=128, seed=0)
    npz = str(base / "ResNet-50-model.npz")
    write_imagenet_npz(npz)
    env = {"COCO_ROOT": root, "MASK_RCNN_TPU_IMAGENET_NPZ": npz}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        result = coco_train.main([
            "--device", "cpu", "--min-size", "64", "--max-size", "96",
            "--max-epoch", "1", "--max-boxes", "8", "--pretrained-model",
            "auto", "--logs-dir", str(base / "logs")])
        report = coco_evaluate.main([result["log_dir"], "--device", "cpu"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return result, report, npz


def test_coco_drivers_write_the_log_dir(coco_run):
    result, report, npz = coco_run
    out = result["log_dir"]
    assert result["iterations"] == 2
    assert {"params.yaml", "log", "snapshot_model.npz",
            "snapshot_model.npz.eval_result.yaml"} <= set(os.listdir(out))
    with open(osp.join(out, "params.yaml")) as f:
        params = json.load(f)
    assert params["dataset"] == "coco"
    assert params["pretrained_model"] == "auto"
    assert params["model_config"]["min_size"] == 64
    with open(osp.join(out, "log")) as f:
        entries = json.load(f)
    losses = [e for e in entries if "main/loss" in e]
    assert [e["iteration"] for e in losses] == [2]
    assert all(np.isfinite(v) for k, v in losses[0].items()
               if k.startswith("main/"))
    assert [e["iteration"] for e in entries
            if "validation/main/map" in e] == [2]
    with open(osp.join(out, "snapshot_model.npz.eval_result.yaml")) as f:
        assert json.load(f)["validation/main/map"] == pytest.approx(
            report["validation/main/map"], nan_ok=True)
    # 'auto' reached train(): the frozen stem is the ImageNet npz's
    like = {"rpn": {}, "head": {}}
    want = import_imagenet_npz(npz, like)["extractor"]["conv1"]["W"]
    with np.load(osp.join(out, "snapshot_model.npz")) as snap:
        np.testing.assert_array_equal(snap["extractor/conv1/W"], want)


def test_port_log_dir_rebuilds_in_jax(coco_run):
    """The JAX package's ``build_model_from_log_dir`` reads the port's JSON
    ``params.yaml`` and snapshot: the same config and parameters."""
    sys.path.insert(0, osp.join(REPO, "examples"))
    try:
        import demo
    finally:
        sys.path.remove(osp.join(REPO, "examples"))
    out = coco_run[0]["log_dir"]
    jmodel, params_yaml = demo.build_model_from_log_dir(out)
    port, _ = log_dir.build_model_from_log_dir(out, device="cpu")
    for k in ("n_fg_class", "n_layers", "min_size", "max_size",
              "anchor_scales", "roi_size", "pooling", "mean"):
        assert getattr(jmodel.config, k) == getattr(port.config, k), k
    got = jax_ckpt.flatten_params(jax.device_get(jmodel.params))
    with np.load(osp.join(out, "snapshot_model.npz")) as snap:
        assert set(got) == set(snap.files)
        for k in snap.files:
            np.testing.assert_array_equal(np.asarray(got[k]), snap[k])
    assert port.device == torch.device("cpu")


def test_port_modules_import_without_jax_cv2_pil_yaml_scipy():
    """Every module of the port, and ``chip_smoke.py``, imports with jax,
    the JAX package, cv2, PIL, pyyaml, scipy and matplotlib made
    unimportable: each of those is imported lazily where it is needed."""
    code = (
        "import importlib, pkgutil, sys\n"
        "BLOCK = ('jax', 'jaxlib', 'mask_rcnn_tpu', 'cv2', 'PIL', 'yaml',\n"
        "         'scipy', 'matplotlib')\n"
        "for name in BLOCK:\n"
        "    sys.modules[name] = None\n"
        "import mask_rcnn_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mask_rcnn_tpu_torch.__path__, 'mask_rcnn_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in BLOCK\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 40


def test_custom_dataset_dir_splits_its_flag(tmp_path, monkeypatch):
    """The custom-dataset drivers take ``--dataset-dir`` (images, npy label
    images, class_names.txt) and hand every other argument on."""
    import cv2

    from mask_rcnn_tpu_torch.examples.custom_dataset import (
        split_dataset_dir,
    )
    from mask_rcnn_tpu_torch.examples.custom_dataset import (
        train as custom_train,
    )

    for d in ("img", "cls", "ins"):
        (tmp_path / d).mkdir()
    cls = np.zeros((20, 30), np.int32)
    ins = np.zeros((20, 30), np.int32)
    cls[2:9, 3:12], ins[2:9, 3:12] = 2, 1
    for name in ("a", "b"):
        cv2.imwrite(str(tmp_path / "img" / f"{name}.png"),
                    np.full((20, 30, 3), 90, np.uint8))
        np.save(tmp_path / "cls" / f"{name}.npy", cls)
        np.save(tmp_path / "ins" / f"{name}.npy", ins)
    (tmp_path / "class_names.txt").write_text("x\ny\n")
    dataset, names, rest = split_dataset_dir(
        ["--dataset-dir", str(tmp_path), "--device", "cpu"])
    assert names == ["x", "y"] and rest == ["--device", "cpu"]
    assert len(dataset) == 2 and dataset.image_sizes() == [(20, 30)] * 2
    assert dataset[1][2].tolist() == [1]
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "MASK_RCNN_TORCH_INIT_METHOD"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        custom_train.main(["--dataset-dir", str(tmp_path), "--multi-node"])
