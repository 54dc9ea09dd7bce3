"""The port's small command-line tools on the CPU, each against its JAX
twin where one exists: the demo, ``coco.speedtest``, ``coco.convert_caffe2``
(params bit-equal to the JAX converter's), the datasets' ``download()``
and ``print_sources_and_verify`` (the same printed text), the dataset
viewer (the same frames in the same order), ``summarize_logs`` (the same
rows) and ``ops.affine_channel``."""

import importlib
import json
import os
import os.path as osp
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from mask_rcnn_tpu.data import _download as jax_download
from mask_rcnn_tpu.data import coco as jax_coco
from mask_rcnn_tpu.data import view_dataset as jax_view
from mask_rcnn_tpu.data import voc as jax_voc
from mask_rcnn_tpu_torch.data import _download, coco, view_dataset, voc
from mask_rcnn_tpu_torch.data._image import read_rgb, write_png
from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_coco_root
from mask_rcnn_tpu_torch.examples import demo, log_dir, summarize_logs
from mask_rcnn_tpu_torch.examples.coco import convert_caffe2, speedtest
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, init_params
from mask_rcnn_tpu_torch.utils.checkpoint import save_params
from mask_rcnn_tpu_torch.utils.logging import dump_params
from tests.test_engine import make_dataset
from tests.torch_import_cases import write_detectron_pkl

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = dict(n_fg_class=3, n_layers=50, min_size=64, max_size=96,
            anchor_scales=[1.0, 2.0], roi_size=14, pooling="align")


def run_jax_script(path, argv, run_name="__main__"):
    """Run one of the JAX package's ``examples/`` scripts in this process
    (they read ``sys.argv``); returns its namespace."""
    old = sys.argv
    sys.argv = [path] + list(argv)
    try:
        return runpy.run_path(path, run_name=run_name)
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def tiny_log_dir(tmp_path_factory):
    """A log dir as a train driver leaves it, at a tiny COCO-like
    configuration with seeded weights."""
    out = str(tmp_path_factory.mktemp("tiny_log"))
    cfg = MaskRCNNConfig(**{**TINY, "anchor_scales": (1.0, 2.0)})
    save_params(osp.join(out, "snapshot_model.npz"),
                init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    dump_params(out, {"dataset": "coco", "model_config": TINY})
    return out


def test_demo_writes_numbered_pictures(tiny_log_dir, tmp_path):
    """Three inputs, two sharing a name: numbered outputs of each input's
    size, drawn (at score threshold 0 every kept detection is)."""
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(((60, 90), (90, 60), (70, 70))):
        d = tmp_path / f"in{i % 2}"
        d.mkdir(exist_ok=True)
        p = str(d / "img.png")
        write_png(p, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        paths.append(p)
    out = str(tmp_path / "out")
    written = demo.main([tiny_log_dir, "--images", *paths, "--score-thresh",
                         "0", "--out", out, "--device", "cpu"])
    assert [osp.basename(p) for p in written] == [
        "000_img.png", "001_img.png", "002_img.png"]
    assert sorted(os.listdir(out)) == ["000_img.png", "001_img.png",
                                       "002_img.png"]
    for src, dst in zip(paths, written):
        a, b = read_rgb(src), read_rgb(dst)
        assert a.shape == b.shape
        assert (a != b).any(), dst


def test_demo_fails_on_a_missing_image_before_building(tiny_log_dir,
                                                       tmp_path,
                                                       monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(log_dir, "build_model_from_log_dir", no_build)
    with pytest.raises(FileNotFoundError):
        demo.main([tiny_log_dir, "--images", str(tmp_path / "none.png"),
                   "--device", "cpu"])


@pytest.mark.parametrize("pipeline", [False, True])
def test_speedtest_from_a_log_dir(tiny_log_dir, capsys, pipeline):
    argv = ["--log-dir", tiny_log_dir, "--n-times", "1", "--device", "cpu"]
    out = speedtest.main(argv + (["--pipeline"] if pipeline else []))
    assert out["pipeline"] == pipeline and out["ms"] > 0
    what = "pipelined" if pipeline else "inference"
    assert f"Average {what} time: " in capsys.readouterr().out


def test_convert_caffe2_matches_jax(tmp_path):
    """The port's log dir holds params bit-equal to the JAX converter's npz
    and the same ``model_config``."""
    pkl = str(tmp_path / "model_final.pkl")
    write_detectron_pkl(pkl, n_fg=80, n_anchor=15, seed=3)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_caffe2.main([pkl, "--out", port_out]) == port_out
    run_jax_script(osp.join(REPO, "examples", "coco", "convert_caffe2.py"),
                   [pkl, "--out", jax_out])
    with np.load(osp.join(port_out, "snapshot_model.npz")) as got, \
            np.load(osp.join(jax_out, "snapshot_model.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(osp.join(port_out, "params.yaml")) as f:
        got = json.load(f)
    with open(osp.join(jax_out, "params.yaml")) as f:
        want = yaml.safe_load(f)
    for k in ("dataset", "model", "model_config", "pretrained_from"):
        assert got[k] == want[k], k


def test_print_sources_and_verify_matches_jax(tmp_path, capsys):
    """One archive whose md5 matches, one (in the flat fallback place) whose
    md5 does not, one absent and one without a checksum: the same text."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "good.tar").write_bytes(b"the archive")
    (tmp_path / "bad.zip").write_bytes(b"not the archive")
    (tmp_path / "nosum.zip").write_bytes(b"x")
    good = _download._file_md5(str(tmp_path / "good.tar"))
    archives = [("good.tar", "http://example.invalid/good.tar", good),
                ("sub/bad.zip", "http://example.invalid/bad.zip", "0" * 32),
                ("absent.tgz", "http://example.invalid/absent.tgz", "1" * 32),
                ("nosum.zip", "http://example.invalid/nosum.zip", None)]
    _download.print_sources_and_verify(str(tmp_path), archives)
    got = capsys.readouterr().out
    jax_download.print_sources_and_verify(str(tmp_path), archives)
    want = capsys.readouterr().out
    assert got == want
    assert "good.tar: http://example.invalid/good.tar  [md5 OK]" in got
    assert "[md5 MISMATCH: " in got


def test_dataset_download_matches_jax(tmp_path, capsys):
    """COCO's ``download()`` (an instance's root) and the VOC2012 and SBD
    class methods print what the JAX package's do, with a matching and a
    mismatching archive on disk."""
    root = make_synthetic_coco_root(str(tmp_path / "COCO"), n_train=1,
                                    n_valminusminival=1, n_minival=1)
    (tmp_path / "COCO" / "annotations" /
     "instances_minival2014.json.zip").write_bytes(b"zip")
    coco.COCOInstanceSegmentationDataset("train", root=root).download()
    got = capsys.readouterr().out
    jax_coco.COCOInstanceSegmentationDataset("train", root=root).download()
    assert got == capsys.readouterr().out
    assert "[md5 MISMATCH" in got

    voc_root = tmp_path / "VOC"
    voc_root.mkdir()
    (voc_root / "benchmark.tgz").write_bytes(b"sbd")
    url, md5 = jax_voc.SBDInstanceSegmentationDataset.DOWNLOAD_ARCHIVES[0][1:]
    for port_cls, jax_cls in (
            (voc.VOC2012InstanceSegmentationDataset,
             jax_voc.VOC2012InstanceSegmentationDataset),
            (voc.SBDInstanceSegmentationDataset,
             jax_voc.SBDInstanceSegmentationDataset)):
        assert port_cls.DOWNLOAD_ARCHIVES == jax_cls.DOWNLOAD_ARCHIVES
        port_cls.download(str(voc_root))
        got = capsys.readouterr().out
        jax_cls.download(str(voc_root))
        assert got == capsys.readouterr().out
    assert f"benchmark.tgz: {url}  [md5 MISMATCH" in got and md5 in got


def test_view_dataset_shows_the_frames_of_jax(monkeypatch):
    """cv2's window calls replaced: keys n, n, p, p, p, q give the same
    frames, in the same order, as the JAX viewer's."""
    ds = make_dataset(n=3, h=40, w=48)
    runs = {}
    for name, fn in (("port", view_dataset.view_dataset),
                     ("jax", jax_view.view_dataset)):
        frames, keys = [], list("nnpppq")
        closed = []
        monkeypatch.setattr(cv2, "imshow",
                            lambda win, img: frames.append((win, img.copy())))
        monkeypatch.setattr(cv2, "waitKey", lambda delay: ord(keys.pop(0)))
        monkeypatch.setattr(cv2, "destroyWindow", closed.append)
        fn(ds, class_names=ds.class_names, window="w")
        assert closed == ["w"] and not keys
        runs[name] = frames
    assert len(runs["port"]) == len(runs["jax"]) == 6
    for (w1, a), (w2, b) in zip(runs["port"], runs["jax"]):
        assert w1 == w2 == "w"
        np.testing.assert_array_equal(a, b)
    # the frames of examples 0, 1, 2, 1, 0, 2 (the index wraps)
    np.testing.assert_array_equal(runs["port"][0][1], runs["port"][4][1])
    np.testing.assert_array_equal(runs["port"][1][1], runs["port"][3][1])


def test_summarize_logs_rows_match_jax(tmp_path, capsys):
    """The port's rows over a port (JSON) log dir, a JAX-style (YAML) one, a
    bare one and one with a broken log equal the JAX script's; the table
    has a line for each."""
    logs = tmp_path / "logs"
    port, jaxd, bare, broken = (logs / n for n in ("a_port", "b_jax",
                                                   "c_bare", "d_broken"))
    for d in (port, jaxd, bare, broken):
        d.mkdir(parents=True)
    dump_params(str(port), {"dataset": "coco", "batch_size": 2,
                            "lr": 0.0025, "model_config": TINY})
    (port / "log").write_text(json.dumps([
        {"iteration": 10, "elapsed_time": 3.5, "main/loss": 2.0},
        {"iteration": 10, "validation/main/map": 0.25},
        {"iteration": 20, "validation/main/map": 0.5},
        {"iteration": 20, "elapsed_time": 7.25, "main/loss": 1.0}]))
    (port / "snapshot_model.npz.eval_result.yaml").write_text(
        json.dumps({"validation/main/map": 0.5}))
    (jaxd / "params.yaml").write_text(yaml.safe_dump(
        {"dataset": "voc", "model": "resnet101", "batch_size": 8,
         "lr": 0.01, "git_hash": "abc1234", "hostname": "h"}))
    (jaxd / "snapshot_model.npz.eval_result.yaml").write_text(
        yaml.safe_dump({"validation/main/map": 0.125}))
    (broken / "log").write_text("{not json")
    (logs / "a_file").write_text("not a run")

    sys.path.insert(0, osp.join(REPO, "examples"))
    try:
        ns = runpy.run_path(osp.join(REPO, "examples", "summarize_logs.py"),
                            run_name="summarize_logs")
    finally:
        sys.path.remove(osp.join(REPO, "examples"))
    rows = summarize_logs.main([str(logs)])
    table = capsys.readouterr().out.splitlines()
    want = [ns["summarize_one"](str(d)) for d in (port, jaxd, bare, broken)]
    assert rows == want
    assert rows[0]["best_map"] == 0.5 and rows[0]["iteration"] == 20
    assert rows[1]["model"] == "resnet101" and rows[1]["eval_map"] == 0.125
    assert len(table) == 2 + 4
    for line, d in zip(table[2:], ("a_port", "b_jax", "c_bare",
                                   "d_broken")):
        assert line.startswith(d)
    assert "eval_map" in table[0]


def test_affine_channel_matches_jax():
    # both packages' ops.affine_channel is the function (ops/__init__.py)
    affine_channel = importlib.import_module(
        "mask_rcnn_tpu_torch.ops.affine_channel")
    jax_affine = importlib.import_module("mask_rcnn_tpu.ops.affine_channel")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    scale = rng.uniform(0.5, 2, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    got = affine_channel.affine_channel(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_affine.affine_channel(x, scale, bias)))
    init = affine_channel.init_affine_channel(8, device="cpu")
    want = jax_affine.init_affine_channel(8)
    for k in ("scale", "bias"):
        assert init[k].dtype == torch.float32 and init[k].device.type == "cpu"
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(want[k]))
