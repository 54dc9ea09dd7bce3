"""The port's overfit checks (``examples/check_train_overfit.py`` and
``examples/check_overfit_map.py`` of ``mask_rcnn_tpu_torch``) against the
JAX scripts on the CPU: the same configuration, optimizer settings, batch
and synthetic dataset, bit for bit, read from the calls each script makes.
The JAX scripts' ``main`` runs with the training calls stubbed out (a
step raises ``Stop``); the port's map check then trains one step and
evaluates for real."""

import dataclasses
import os.path as osp
import runpy
import sys
import types

import numpy as np
import pytest

# Every module the scripts import is imported here first, so that none of
# them binds a stub below as its own name.
import mask_rcnn_tpu.engine as jax_engine
import mask_rcnn_tpu.models as jax_models
import mask_rcnn_tpu.models.api  # noqa: F401
import mask_rcnn_tpu_torch.engine.loop  # noqa: F401
import mask_rcnn_tpu_torch.engine.trainer as port_trainer
import mask_rcnn_tpu_torch.models.api  # noqa: F401
import mask_rcnn_tpu_torch.models.mask_rcnn as port_models
from mask_rcnn_tpu_torch.examples import check_overfit_map as port_map
from mask_rcnn_tpu_torch.examples import check_train_overfit as port_overfit
from mask_rcnn_tpu_torch.examples import train_common as port_train_common

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_OVERFIT = osp.join(REPO, "examples", "check_train_overfit.py")
JAX_MAP = osp.join(REPO, "examples", "check_overfit_map.py")


class Stop(Exception):
    """Raised by a stubbed train step once it has seen its first call."""


def stub_training(monkeypatch, engine, models_module, seen):
    """Replace ``init_params``, ``make_optimizer``, ``create_train_state``
    and ``make_train_step`` with recorders that return ``None`` (an empty
    tree); the step records its batch and raises ``Stop``."""

    def init_params(*args):
        seen["cfg"] = next(a for a in args if dataclasses.is_dataclass(a))
        return None

    def make_optimizer(params, **kw):
        seen["optimizer"] = kw
        return None, None

    def make_train_step(cfg, optimizer, **kw):
        seen["step_cfg"], seen["targets"] = cfg, kw

        def step(state, batch, key):
            seen["batch"] = {k: np.asarray(v) for k, v in batch.items()}
            raise Stop

        return step

    monkeypatch.setattr(models_module, "init_params", init_params)
    monkeypatch.setattr(engine, "make_optimizer", make_optimizer)
    monkeypatch.setattr(engine, "create_train_state", lambda p, o: None)
    monkeypatch.setattr(engine, "make_train_step", make_train_step)


def test_train_overfit_configuration_is_the_jax_scripts(monkeypatch):
    """``run_overfit`` builds the JAX script's model configuration, target
    samplers, optimizer settings and two-image batch (bit for bit)."""
    import jax

    jax_seen, port_seen = {}, {}
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    stub_training(monkeypatch, jax_engine, jax_models, jax_seen)
    with pytest.raises(Stop):
        runpy.run_path(JAX_OVERFIT)["main"]()
    stub_training(monkeypatch, port_trainer, port_models, port_seen)
    with pytest.raises(Stop):
        port_overfit.run_overfit(device="cpu")

    for seen in (jax_seen, port_seen):
        assert seen["cfg"] is seen["step_cfg"]
    assert (dataclasses.asdict(port_seen["cfg"])
            == dataclasses.asdict(jax_seen["cfg"]))
    assert port_seen["optimizer"] == jax_seen["optimizer"] == dict(
        base_lr=2e-3, total_steps=100000, clip_norm=10.0)
    assert port_seen["targets"].keys() == jax_seen["targets"].keys()
    for k, v in jax_seen["targets"].items():
        assert dataclasses.asdict(port_seen["targets"][k]) == \
            dataclasses.asdict(v), k
    port_batch, jax_batch = port_seen["batch"], jax_seen["batch"]
    assert port_batch.keys() == jax_batch.keys()
    for k, v in jax_batch.items():
        assert port_batch[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port_batch[k], v, err_msg=k)


def load_jax_map_script(monkeypatch):
    """The JAX map script's globals; its module-level ``sys.path`` insert
    is undone when the test ends."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    return runpy.run_path(JAX_MAP)


def assert_same_examples(port_ds, jax_ds, n):
    for i in range(n):
        for a, b in zip(port_ds[i], jax_ds[i], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_overfit_map_dataset_is_the_jax_generators(monkeypatch):
    """``make_synthetic_voc_like`` at its defaults: the JAX generator's 20
    images, boxes, labels and masks, bit for bit."""
    jax_make = load_jax_map_script(monkeypatch)["make_synthetic_voc_like"]
    port_ds, jax_ds = port_map.make_synthetic_voc_like(), jax_make()
    assert len(port_ds) == len(jax_ds) == 20
    assert port_ds.class_names == jax_ds.class_names
    assert_same_examples(port_ds, jax_ds, 20)


def test_overfit_map_runs_with_the_jax_scripts_flags(monkeypatch, tmp_path):
    """The map check for one step and one evaluation on the CPU, at batch
    1 over the generator's first image: its trajectory is read from the log, and
    the flags and driver arguments it trains with equal those the JAX
    script hands its ``train_common.train`` at the same command line."""
    cli = {"max_epoch": 1.0, "batch_size_per_gpu": 1,
           "eval_interval_epochs": 1.0, "logs_dir": str(tmp_path / "logs")}
    calls = {}

    def recorder(name, train):
        def record(args, train_data, test_data, class_names, kind, **kw):
            calls[name] = (vars(args).copy(), train_data, test_data,
                           class_names, kind, kw)
            return train(args, train_data, test_data, class_names, kind,
                         **kw)
        return record

    jax_train = types.ModuleType("train_common")
    jax_train.train = recorder("jax", lambda *a, **kw: {
        "best_map": 1.0, "iterations": 1, "elapsed": 1.0})
    jax_main = load_jax_map_script(monkeypatch)["main"]
    monkeypatch.setitem(sys.modules, "train_common", jax_train)
    monkeypatch.setattr(sys, "argv", [
        JAX_MAP, "--max-epoch", "1", "--batch-size-per-gpu", "1",
        "--eval-interval-epochs", "1", "--logs-dir", cli["logs_dir"]])
    assert jax_main() == 0

    monkeypatch.setattr(port_train_common, "train",
                        recorder("port", port_train_common.train))
    result = port_map.run_overfit_map(device="cpu", n_images=1, **cli)

    port_args, port_train, port_test, *port_rest = calls["port"]
    jax_args, jax_train_ds, jax_test, *jax_rest = calls["jax"]
    assert {k: port_args[k] for k in jax_args} == jax_args
    assert {k: jax_args[k] for k in cli} == cli
    # the fields the JAX namespace lacks: the driver's size flags stay
    # unset, so train()'s min/max arguments apply
    assert {k: port_args[k] for k in ("min_size", "max_size", "device")} \
        == {"min_size": None, "max_size": None, "device": "cpu"}
    assert port_rest == jax_rest == [
        ("box", "disk", "stripe"), "voc",
        {"min_size": 320, "max_size": 448, "anchor_scales": (2, 4, 8, 16)}]
    assert port_train is port_test and jax_train_ds is jax_test
    assert len(port_train) == 1
    assert_same_examples(port_train, jax_train_ds, 1)

    assert result["iterations"] == 1
    assert [it for it, _ in result["trajectory"]] == [1]
    assert max(m for _, m in result["trajectory"]) == result["best_map"]
    assert 0.0 <= result["best_map"] <= 1.0
