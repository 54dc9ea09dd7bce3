"""The port's training driver (``engine/loop.py::train``) and checkpoints
(``utils/checkpoint.py``) on the CPU: the JAX package's end-to-end checks on
its tiny configuration, a resume that reproduces an uninterrupted run bit
for bit, train-state round trips, and the artifacts read by the JAX
package (``snapshot_model.npz`` through ``load_params(like=...)``,
``params.yaml`` through ``load_params_yaml``)."""

import functools
import inspect
import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import rpn as jax_rpn
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu.utils.logging import load_params_yaml
from mask_rcnn_tpu_torch.data import MaskRCNNTransform, TrainLoader
from mask_rcnn_tpu_torch.engine import loop, trainer
from mask_rcnn_tpu_torch.engine.evaluator import InstanceSegmentationEvaluator
from mask_rcnn_tpu_torch.engine.loop import train
from mask_rcnn_tpu_torch.models import api, mask_rcnn, rpn
from mask_rcnn_tpu_torch.models.targets import (
    AnchorTargetConfig,
    ProposalTargetConfig,
)
from mask_rcnn_tpu_torch.utils import checkpoint
from tests.test_engine import make_dataset

PROPOSAL = dict(n_train_pre_nms=64, n_train_post_nms=16, n_test_pre_nms=64,
                n_test_post_nms=16)


@pytest.fixture
def small_targets(monkeypatch):
    """Smaller target samples than the reference's 128 rois / 256 anchors,
    so that the R-50 head trains in ~1 s a step on the CPU; ``train()``
    itself always takes the reference's."""
    monkeypatch.setattr(loop, "make_train_step", functools.partial(
        trainer.make_train_step,
        proposal_cfg=ProposalTargetConfig(n_sample=16),
        anchor_cfg=AnchorTargetConfig(n_sample=64)))


def tiny_cfg():
    """tests/test_engine.py::test_train_loop_end_to_end's configuration."""
    return mask_rcnn.MaskRCNNConfig(
        n_fg_class=1, min_size=64, max_size=64, anchor_scales=(1.0, 2.0),
        proposal=rpn.ProposalConfig(**PROPOSAL), detections_per_im=4)


def jax_tiny_cfg():
    return jax_mrcnn.MaskRCNNConfig(
        n_fg_class=1, min_size=64, max_size=64, anchor_scales=(1.0, 2.0),
        proposal=jax_rpn.ProposalConfig(**PROPOSAL), detections_per_im=4)


def make_loader(ds, train_transform=True, **kw):
    return TrainLoader(
        ds, MaskRCNNTransform(64, 64, tiny_cfg().mean, train=train_transform,
                              rng=np.random.RandomState(0)),
        batch_size=2, max_boxes=2, min_size=64, max_size=64, **kw)


def test_train_loop_end_to_end(tmp_path, small_targets):
    """The checks of tests/test_engine.py::test_train_loop_end_to_end, and
    the artifacts read back by the JAX package."""
    ds = make_dataset()
    evaluator = InstanceSegmentationEvaluator(ds, ds.class_names, kind="voc",
                                              max_examples=1)
    out = str(tmp_path)
    result = train(tiny_cfg(), make_loader(ds), out, max_epoch=1.0,
                   evaluator=evaluator, log_interval=5,
                   eval_interval_epochs=1.0, device="cpu")
    assert result["iterations"] == 2
    assert osp.exists(osp.join(out, "params.yaml"))
    assert osp.exists(osp.join(out, "snapshot_model.npz"))
    with open(osp.join(out, "log")) as f:
        entries = json.load(f)
    assert any("main/loss" in e for e in entries)
    assert any("validation/main/map" in e for e in entries)
    # the flushed entry is stamped with the epoch its steps ran in (0)
    flushed = [e for e in entries if "main/loss" in e]
    assert all(e["epoch"] == 0 for e in flushed)
    assert all(np.isfinite(e["main/loss"]) for e in flushed)

    # params.yaml (JSON) reads with the JAX package's yaml reader
    meta = load_params_yaml(out)
    assert meta["batch_size"] == 2 and meta["n_devices"] == 1
    assert meta["lr"] == pytest.approx(0.0025)
    assert meta["model_config"]["proposal"]["n_train_post_nms"] == 16
    assert "hostname" in meta and "git_hash" in meta

    # the snapshot loads in the JAX package against its own param tree
    # (shapes and dtypes from init_params, traced without running it)
    like = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
            lambda: jax_mrcnn.init_params(jax.random.PRNGKey(0),
                                          jax_tiny_cfg())))
    loaded = jax_ckpt.flatten_params(jax_ckpt.load_params(
        osp.join(out, "snapshot_model.npz"), like=like))
    assert set(loaded) == set(jax_ckpt.flatten_params(like))


def final_params(out):
    return checkpoint.flatten_params(
        checkpoint.load_params(osp.join(out, "snapshot_model.npz")))


def test_resume_is_bit_identical(tmp_path, small_targets):
    """Interrupted after step 1 (checkpoint every step) and resumed to the
    end: the params equal an uninterrupted run's bit for bit, and the log
    continues at step 2. The eval transform keeps the data deterministic:
    the train transform's flips come from a generator that the checkpoint
    does not hold (as in the JAX package)."""
    ds = make_dataset()
    cfg = tiny_cfg()
    kw = dict(max_epoch=1.0, log_interval=1, device="cpu")
    full = str(tmp_path / "full")
    train(cfg, make_loader(ds, False), full, **kw)
    part = str(tmp_path / "part")
    r = train(cfg, make_loader(ds, False), part, stop_at_step=1,
              checkpoint_interval_steps=1, **kw)
    assert r["iterations"] == 1
    rest = str(tmp_path / "rest")
    r = train(cfg, make_loader(ds, False), rest,
              resume_from=osp.join(part, "train_state"), **kw)
    assert r["iterations"] == 2
    want, got = final_params(full), final_params(rest)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with open(osp.join(rest, "log")) as f:
        assert [e["iteration"] for e in json.load(f)] == [2]


def test_train_state_round_trip_is_bit_identical(tmp_path):
    cfg = tiny_cfg()
    params = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(3))
    opt, _ = trainer.make_optimizer(params, 0.01, 10)
    state = trainer.create_train_state(params, opt)
    gen = torch.Generator().manual_seed(4)
    for v in checkpoint.flatten_params(state.momentum).values():
        v.copy_(torch.randn(v.shape, generator=gen))
    state = trainer.TrainState(state.params, state.momentum, 7)
    d = str(tmp_path / "ck")
    checkpoint.save_train_state(d, state)
    assert not osp.exists(osp.join(d, "state.tmp.npz"))  # renamed
    like = trainer.create_train_state(
        mask_rcnn.init_params(cfg, torch.Generator().manual_seed(5)), opt)
    restored = checkpoint.restore_train_state(d, like)
    assert restored.step == 7
    for part in ("params", "momentum"):
        want = checkpoint.flatten_params(getattr(state, part))
        got = checkpoint.flatten_params(getattr(restored, part))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert got[k].requires_grad == want[k].requires_grad, k


def test_load_params_conforms_to_like(tmp_path):
    cfg = tiny_cfg()
    params = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(0))
    path = str(tmp_path / "p.npz")
    checkpoint.save_params(path, params)
    back = checkpoint.load_params(path, like=params)
    for k, v in checkpoint.flatten_params(params).items():
        assert torch.equal(checkpoint.flatten_params(back)[k], v)
    other = mask_rcnn.init_params(
        mask_rcnn.MaskRCNNConfig(n_fg_class=2, min_size=64, max_size=64),
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_params(path, like=other)
    del other["head"]["mask"]
    with pytest.raises(ValueError, match="param tree mismatch"):
        checkpoint.conform_params(params, other)


def test_train_refuses_a_batch_across_devices(tmp_path):
    ds = make_dataset(n=6)
    loader = TrainLoader(ds, MaskRCNNTransform(64, 64, mean=(0, 0, 0)),
                         batch_size=2, max_boxes=4, min_size=64, max_size=64)
    # one process drives one device: a batch of two devices wants torchrun
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train(tiny_cfg(), loader, str(tmp_path), max_epoch=1.0,
              batch_size_per_device=1, device="cpu")
    loader.batch_size = 3
    with pytest.raises(ValueError, match="multiple of"):
        train(tiny_cfg(), loader, str(tmp_path), max_epoch=1.0,
              batch_size_per_device=2, device="cpu")


def test_model_and_train_default_to_the_card():
    for fn in (api.MaskRCNNResNet.__init__, train):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
