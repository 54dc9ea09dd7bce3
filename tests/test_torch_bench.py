"""The port's headline benchmark (``mask_rcnn_tpu_torch/bench.py``) against
``bench.py``, on the CPU: the configuration, the input shapes and the
chain lengths read from ``bench.py`` itself; the served image and the
synthetic b2 batch equal, bit for bit, what ``bench.py``'s own calls feed;
a tiny run prints ``bench.py``'s JSON keys plus ``device``; no card means
a non-zero exit before anything is built; and a failure is not retried or
swallowed."""

import ast
import dataclasses
import inspect
import json
import math
import os
import os.path as osp
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

import mask_rcnn_tpu.models as jax_models
import mask_rcnn_tpu.utils.profiling as jax_profiling
from mask_rcnn_tpu_torch import bench
from mask_rcnn_tpu_torch.models import mask_rcnn as port_mask_rcnn
from mask_rcnn_tpu_torch.ops import costs
from mask_rcnn_tpu_torch.utils import profiling as port_profiling
from tests.torch_profile_cases import one_thread, tool_kwargs

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_BENCH = osp.join(REPO, "bench.py")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _jax_bench_ast():
    with open(JAX_BENCH) as f:
        return ast.parse(f.read())


def _call_keywords(tree, name):
    """[{keyword: literal}] of every call to ``name`` (a bare name or an
    attribute) in ``tree``."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if called == name:
                found.append({k.arg: ast.literal_eval(k.value)
                              for k in node.keywords})
    return found


def _assigned(tree, target):
    """The literal value of the one assignment to ``target`` (a name, or a
    tuple of names written "a, b"), with an ``np.asarray(literal, ...)``
    call read as its literal."""
    values = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                     else [getattr(t, "id", None)])
            if ", ".join(map(str, names)) == target:
                value = node.value
                if isinstance(value, ast.Call):
                    value = value.args[0]
                values.append(ast.literal_eval(value))
    assert len(values) == 1, (target, values)
    return values[0]


def _dict_keys(tree, func):
    """The keys of the dict literals in ``func``'s body that hold a
    "metric" or a "step_ms" key: the JSON line and its "train" part."""
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = [ast.literal_eval(k) for k in node.keys]
            if "metric" in keys or "step_ms" in keys:
                return keys
    raise AssertionError(f"no result dict in {func}")


def _plain(value):
    if dataclasses.is_dataclass(value):
        return {k: _plain(v) for k, v in dataclasses.asdict(value).items()}
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    return value


class _Stop(Exception):
    """Raised by a stub once it has recorded what it was given."""


def test_config_shapes_and_chains_match_jax_script(monkeypatch):
    """What ``run`` builds is ``bench.py``'s ``MaskRCNNConfig(...)`` (every
    field of the two configurations equal), and the bench's image shape,
    ``sizes``, ``scales``, dispatch loop, chain lengths, baseline and
    train batch are ``bench.py``'s, read from its source."""
    tree = _jax_bench_ast()
    (kw,) = _call_keywords(tree, "MaskRCNNConfig")
    want = _plain(jax_models.MaskRCNNConfig(**kw))

    built = []

    def init_params(cfg, *args, **kwargs):
        built.append(cfg)
        raise _Stop

    monkeypatch.setattr(port_mask_rcnn, "init_params", init_params)
    with pytest.raises(_Stop):
        bench.run(device="cpu")
    assert _plain(built[0]) == want

    ns = runpy.run_path(JAX_BENCH)
    assert bench.BASELINE_HZ == ns["BASELINE_HZ"]
    assert bench.TRAIN_BATCH == ns["TRAIN_BATCH"]
    assert bench.IMAGE_HW == _assigned(tree, "h, w")
    assert bench.SIZES == _assigned(tree, "sizes")
    assert bench.SCALES == _assigned(tree, "scales")
    defaults = {k: p.default
                for k, p in inspect.signature(bench.run).parameters.items()}
    assert (bench.DISPATCH_WARMUP, bench.DISPATCH_CALLS) == _assigned(
        tree, "n_warmup, n_eval")
    (serve,) = _call_keywords(tree, "time_fn_chained")
    (train,) = _call_keywords(tree, "time_train_steps_chained")
    assert (defaults["reps"], defaults["iters"]) == (serve["reps"],
                                                     serve["iters"])
    assert (defaults["step_reps"], defaults["step_iters"]) == (
        train["reps"], train["iters"])


def test_inputs_match_jax_script_bit_for_bit(monkeypatch):
    """The served image, ``sizes`` and ``scales`` that ``bench.py``'s
    ``main`` hands its jitted predict step, and the batch that its
    ``bench_train`` hands ``time_train_steps_chained`` at a small h, w, are
    the port's inputs bit for bit (``bench.py``'s calls run with the jit
    and the timing stubbed to record their arguments)."""
    fed = {}
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        if sys._getframe(1).f_code.co_filename != JAX_BENCH:
            return real_jit(fn, *args, **kwargs)

        def record(params, images, sizes, scales):
            fed.update(images=images, sizes=sizes, scales=scales)
            raise _Stop
        return record

    def chained(step, state, batch, key, **kw):
        fed["batch"] = batch
        raise _Stop

    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(jax_models, "init_params", lambda key, cfg: {})
    monkeypatch.setattr(jax_profiling, "time_train_steps_chained", chained)
    ns = runpy.run_path(JAX_BENCH)
    with pytest.raises(_Stop):
        ns["main"]()
    h, w = 256, 320
    cfg = jax_models.MaskRCNNConfig(n_fg_class=80)
    with pytest.raises(_Stop):
        ns["bench_train"](cfg, {}, h, w)

    image = bench.serve_image(*bench.IMAGE_HW)
    want = np.asarray(fed["images"])
    assert image.dtype == want.dtype and image.shape == want.shape
    assert np.array_equal(image, want)
    assert np.array_equal(np.asarray(fed["sizes"]),
                          np.asarray(bench.SIZES, np.float32))
    assert np.array_equal(np.asarray(fed["scales"]),
                          np.asarray(bench.SCALES, np.float32))
    batch = bench.train_batch(bench.TRAIN_BATCH, h, w)
    assert set(batch) == set(fed["batch"])
    for k, v in fed["batch"].items():
        v = np.asarray(v)
        assert batch[k].dtype == v.dtype and batch[k].shape == v.shape, k
        assert np.array_equal(batch[k], v), k


def test_tiny_cpu_run_prints_jax_keys_plus_device(monkeypatch, capsys):
    """R-50 on one 64x96 image, a few rois, chains of one call: one JSON
    line on stdout with ``bench.py``'s keys plus ``device``, finite values,
    ``vs_baseline`` and ``images_per_sec`` consistent with ``value`` and
    ``step_ms``, no MFU and a metric that names the CPU; no cost counter
    or dispatch mode is active while the chains are timed."""
    active = []

    def watch(name):
        fn = getattr(port_profiling, name)

        def wrapped(*args, **kwargs):
            active.append((name, costs.ACTIVE,
                           len(_get_current_dispatch_mode_stack())))
            return fn(*args, **kwargs)
        monkeypatch.setattr(port_profiling, name, wrapped)

    watch("time_fn_chained")
    watch("time_train_steps_chained")
    result = bench.run(reps=1, step_reps=1, step_iters=1, **tool_kwargs())
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert "sequential dispatch-included" in err
    assert active == [("time_fn_chained", None, 0),
                      ("time_train_steps_chained", None, 0)]

    tree = _jax_bench_ast()
    assert list(result) == _dict_keys(tree, "main") + ["device"]
    train = result["train"]
    assert list(train) == _dict_keys(tree, "bench_train")
    for v in (result["value"], result["vs_baseline"], train["step_ms"],
              train["images_per_sec"]):
        assert math.isfinite(v) and v > 0
    assert result["vs_baseline"] == round(result["value"] / 3.24, 2)
    n, ms = train["batch"], train["step_ms"]
    assert abs(train["images_per_sec"] - n / ms * 1e3) <= (
        0.005 + 0.005 * n * 1e3 / (ms - 0.005) ** 2)
    assert train["mfu"] is None
    assert "cpu" in result["metric"] and result["device"] == "cpu"
    assert result["unit"] == "images/sec"
    assert (n, train["dtype"], train["image_hw"]) == (1, "bfloat16",
                                                      [64, 96])


def test_no_card_exits_before_building(monkeypatch, capsys):
    """``--device cuda`` (and the default) with no card: exit code 1 and a
    message on stderr, with nothing built and nothing on stdout; the same
    from ``python -m mask_rcnn_tpu_torch.bench`` with no card visible."""

    def init_params(*args, **kwargs):
        raise AssertionError("built params without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_mask_rcnn, "init_params", init_params)
    for argv in (["--device", "cuda"], []):
        assert bench.main(argv) == 1
        out, err = capsys.readouterr()
        assert out == "" and "no CUDA device" in err

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-m", "mask_rcnn_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 1, res.stderr
    assert res.stdout == "" and "no CUDA device" in res.stderr


@pytest.mark.parametrize("failing", ["time_fn_chained", "cost_of"])
def test_failure_is_neither_retried_nor_swallowed(monkeypatch, capsys,
                                                  failing):
    """A timing helper or ``cost_of`` that raises, patched in, makes
    ``main`` raise after one call, with no JSON line printed (the model is
    stubbed; the served image is the bench's)."""
    served, calls = [], []

    def predict_step(params, cfg, images, sizes, scales):
        served.append(images)
        return {"scores": images[:, :1, 0, 0]}

    def fail(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("short profiler capture")

    monkeypatch.setattr(port_mask_rcnn, "init_params",
                        lambda cfg, gen, device: {})
    monkeypatch.setattr(port_mask_rcnn, "predict_step", predict_step)
    monkeypatch.setattr(port_profiling, "time_fn_chained",
                        lambda *args, **kwargs: 10.0)
    monkeypatch.setattr(port_profiling, failing, fail)
    with pytest.raises(RuntimeError, match="short profiler capture"):
        bench.main(["--device", "cpu"])
    assert calls == [1]
    assert capsys.readouterr().out == ""
    assert len(served) == bench.DISPATCH_WARMUP + bench.DISPATCH_CALLS
    assert np.array_equal(served[0].numpy(),
                          bench.serve_image(*bench.IMAGE_HW))
