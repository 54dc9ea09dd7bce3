"""The port's data parallelism (``mask_rcnn_tpu_torch/parallel/mesh.py``)
in one process: the helpers without a process group against the JAX
package's, sharded predict against the single-device path with every
collective made to raise (it runs none), the train step's hooks (global
rows of the sampling priorities, global loss denominators, one flat
buffer per dtype), ``init_distributed``'s refusals, and a world of one
gloo rank, whose step is the plain step."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mask_rcnn_tpu.parallel import local_batch_slice as jax_local_batch_slice
from mask_rcnn_tpu_torch.engine import trainer
from mask_rcnn_tpu_torch.engine.evaluator import InstanceSegmentationEvaluator
from mask_rcnn_tpu_torch.models import api, mask_rcnn, rpn, targets
from mask_rcnn_tpu_torch.models.mask_rcnn import predict_step
from mask_rcnn_tpu_torch.ops import losses
from mask_rcnn_tpu_torch.parallel import mesh
from mask_rcnn_tpu_torch.utils import checkpoint
from tests import torch_parallel_worker as worker

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_object",
               "broadcast_object_list", "barrier", "reduce_scatter",
               "init_process_group")


@pytest.fixture
def no_collectives(monkeypatch):
    """Every ``torch.distributed`` collective (and group set-up) raises."""
    def refuse(*a, **k):
        raise AssertionError("a collective ran")

    for name in COLLECTIVES:
        monkeypatch.setattr(dist, name, refuse)


def test_process_helpers_without_a_group():
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.process_zero()
    assert mesh.local_batch_slice(4) == slice(0, 4)
    for args in ((8, 1, 2), (8, 0, 4), (6, 2, 3), (3, 0, 1)):
        assert mesh.local_batch_slice(*args) == jax_local_batch_slice(*args)
    with pytest.raises(ValueError, match="never be assigned"):
        mesh.local_batch_slice(7, 0, 2)
    mesh.barrier()  # nothing to wait for
    mesh.broadcast_params({"a": torch.ones(2)})


def tiny_model():
    """``tests/test_parallel.py::tiny_cfg`` behind the model API."""
    return api.MaskRCNNResNet(
        n_fg_class=2, min_size=64, max_size=64, anchor_scales=(1.0, 2.0),
        proposal_creator_params=dict(n_test_pre_nms=64, n_test_post_nms=16),
        device="cpu")


def assert_outputs_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_sharded_predict_matches_single_device(no_collectives):
    """``devices=("cpu", "cpu")`` (the JAX ``mesh=``) on a batch of 3,
    padded to 4: the single-device outputs (the JAX package's
    ``test_parallel_predict_matches_single_device`` bound), and no
    collective."""
    model = tiny_model()
    model.score_thresh = 0.0
    sharded = api.MaskRCNNResNet.from_config(
        model.config, model.params, devices=("cpu", "cpu"))
    sharded.score_thresh = 0.0
    assert sharded.devices == (torch.device("cpu"),) * 2
    rng = np.random.RandomState(3)
    imgs = [rng.uniform(0, 255, (3, 64, 64)).astype(np.float32)
            for _ in range(3)]
    want, _, n = model.predict_submit(imgs)
    got, _, n_got = sharded.predict_submit(imgs)
    assert n == n_got == 3 and got["scores"].shape[0] == 3
    assert_outputs_close(got, want)
    for a, b in zip(model.predict(imgs), sharded.predict(imgs)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


def test_parallel_predict_step_over_8_devices(no_collectives):
    """The function form over 8 (CPU) devices on 8 images, as the JAX
    package's test runs its 8-device mesh."""
    model = tiny_model()
    cfg = model.config
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randn(8, 64, 64, 3).astype(np.float32)
                              * 10)
    sizes = torch.full((8, 2), 64.0)
    scales = torch.ones(8)
    with torch.no_grad():
        want = predict_step(model.params, cfg, images, sizes, scales)
        devices = ["cpu"] * 8
        step = mesh.make_parallel_predict_step(
            lambda p, i, s, sc: predict_step(p, cfg, i, s, sc), devices)
        got = step(mesh.replicate_params(model.params, devices), images,
                   sizes, scales)
    assert_outputs_close(got, want)


def train_setup():
    cfg = worker.tiny_cfg()
    params = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(0))
    opt, _ = trainer.make_optimizer(params, 0.01, 10)
    return cfg, params, opt


def test_parallel_train_step_without_a_group_is_the_plain_step(
        no_collectives):
    from tests.test_torch_multiprocess import step_batch

    batch = {k: torch.from_numpy(v) for k, v in step_batch().items()}
    results = []
    for wrap in (None, mesh.make_parallel_train_step):
        cfg, params, opt = train_setup()
        state = trainer.create_train_state(params, opt)
        step = trainer.make_train_step(cfg, opt, **worker.step_kwargs())
        if wrap is not None:
            step = wrap(step)
        state, m = step(state, batch, 3)
        results.append((m, checkpoint.flatten_params(state.params)))
    (m0, p0), (m1, p1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_global_rows_draw_the_one_process_priorities():
    """Image 1 of a global batch of 2, drawing the global batch's
    priorities and keeping its row, samples as in the one-process batch;
    given priorities must cover the global batch."""
    rng = np.random.RandomState(0)
    y1x1 = rng.uniform(0, 40, (300, 2))
    anchors = torch.from_numpy(np.concatenate(
        [y1x1, y1x1 + rng.uniform(8, 30, (300, 2))], 1).astype(np.float32))
    bbox = torch.from_numpy(np.asarray(
        [[[5, 5, 30, 40], [0, 0, 0, 0]], [[10, 20, 50, 60], [2, 3, 20, 24]]],
        np.float32))
    valid = torch.tensor([[True, False], [True, True]])
    cfg = targets.AnchorTargetConfig(n_sample=32)

    def gen():
        return torch.Generator().manual_seed(5)

    whole = targets.anchor_targets(bbox, valid, anchors, (64, 64), cfg,
                                   generator=gen())
    row = targets.anchor_targets(bbox[1:], valid[1:], anchors, (64, 64), cfg,
                                 generator=gen(), rows=(1, 2))
    for a, b in zip(whole, row):
        assert torch.equal(a[1:], b)
    alone = targets.anchor_targets(bbox[1:], valid[1:], anchors, (64, 64),
                                   cfg, generator=gen())
    assert not torch.equal(alone[1], whole[1][1:])
    with pytest.raises(ValueError, match="global batch has 2"):
        targets.anchor_targets(
            bbox[1:], valid[1:], anchors, (64, 64), cfg, rows=(1, 2),
            priorities=(torch.rand(1, 300), torch.rand(1, 300)))


def test_losses_take_a_global_denominator():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(12, 3).astype(np.float32))
    labels = torch.tensor([0, 1, 2, -1, 1, 0, -1, 2, 2, 1, 0, 1])
    locs = torch.from_numpy(rng.randn(12, 4).astype(np.float32))
    gt = torch.from_numpy(rng.randn(12, 4).astype(np.float32))
    valid = float((labels >= 0).sum())
    for fn, args in ((losses.softmax_cross_entropy, (logits, labels)),
                     (losses.sigmoid_cross_entropy,
                      (logits[:, 0], labels.clamp(max=1))),
                     (losses.fast_rcnn_loc_loss, (locs, gt, labels, 1.0))):
        mean = fn(*args)
        for denom in (25.0, 0.0):
            got = fn(*args, denom=torch.tensor(denom))
            torch.testing.assert_close(
                got, mean * valid / max(denom, 1.0), rtol=1e-6, atol=0)


def test_collectives_run_one_flat_buffer_per_dtype():
    tensors = [torch.ones(2, 3), torch.full((4,), 2.0, dtype=torch.bfloat16),
               torch.arange(5.0), torch.ones(1, dtype=torch.bfloat16)]
    calls = []

    def double(flat):
        calls.append((flat.dtype, flat.numel()))
        flat.mul_(2)

    out = mesh._by_dtype(tensors, double)
    assert sorted(calls, key=str) == sorted(
        [(torch.float32, 11), (torch.bfloat16, 5)], key=str)
    for t, o in zip(tensors, out):
        assert o.shape == t.shape and o.dtype == t.dtype
        assert torch.equal(o, t * 2)


def test_init_distributed_refuses_without_torchrun_or_a_backend(
        monkeypatch, tmp_path):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              mesh.INIT_METHOD_ENV):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        mesh.init_distributed(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.init_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="'mpi' is not available"):
        mesh.init_distributed("mpi", "cpu", init_method=(
            "file://" + str(tmp_path / "store")))
    assert not mesh.is_distributed()


@pytest.fixture
def world_of_one(monkeypatch, tmp_path):
    """This process as the only rank of a gloo group (a FileStore in
    ``tmp_path``)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    dev = mesh.init_distributed("gloo", "cpu", timeout=60, init_method=(
        "file://" + str(tmp_path / "store")))
    try:
        yield dev
    finally:
        mesh.destroy_distributed()


def test_world_of_one_step_and_evaluation_equal_one_process(world_of_one):
    """The data-parallel step at world size 1 runs its collectives and
    gives the plain step bit for bit; the evaluator, pooled or not, gives
    the one-process report."""
    from tests.test_torch_multiprocess import step_batch

    assert mesh.is_distributed() and mesh.process_count() == 1
    batch = {k: torch.from_numpy(v) for k, v in step_batch().items()}
    results = []
    for wrap in (None, mesh.make_parallel_train_step):
        cfg, params, opt = train_setup()
        state = trainer.create_train_state(params, opt)
        mesh.broadcast_params(state.params)
        step = trainer.make_train_step(cfg, opt, **worker.step_kwargs())
        if wrap is not None:
            step = wrap(step)
        for _ in range(2):
            state, m = step(state, batch, 3)
        results.append((m, checkpoint.flatten_params(state.params)))
    (m0, p0), (m1, p1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)

    ds, examples = worker.eval_dataset(5)
    reports = [InstanceSegmentationEvaluator(
        ds, worker.EVAL_CLASSES, kind="coco", pool_detections=pool)(
            worker.StubModel(examples)) for pool in (False, True)]
    assert "validation/main/map" in reports[0]
    assert reports[0] == reports[1]


@pytest.mark.parametrize("code, match", [
    ("import os, sys; sys.exit(int(os.environ['RANK']))", r"rank\(s\) \[1\]"),
    ("import time; time.sleep(60)", "still running after 3 s"),
])
def test_launcher_fails_on_a_failed_or_hung_rank(code, match, monkeypatch):
    """``dryrun.launch``: a rank that exits non-zero, or ranks that outlive
    the timeout, fail the launch, and no rank is left running."""
    import subprocess
    import sys
    import time

    from mask_rcnn_tpu_torch.parallel.dryrun import launch

    started = []
    real_popen = subprocess.Popen

    def popen(*a, **k):
        started.append(real_popen(*a, **k))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        launch([sys.executable, "-c", code], 2, timeout=3)
    assert time.monotonic() - t0 < 30
    assert len(started) == 2 and all(p.poll() is not None for p in started)


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch, capsys):
    """The dry run's ranks take ``cuda`` (``cuda:{LOCAL_RANK}``, NCCL)
    unless the caller passes ``--device cpu``; with no card and no
    ``--nproc`` it fails before starting a rank."""
    from mask_rcnn_tpu_torch.parallel import dryrun

    calls = []
    monkeypatch.setattr(dryrun, "launch",
                        lambda cmd, nproc, timeout: calls.append((cmd, nproc)))
    assert dryrun.main(["--nproc", "1"]) == 0
    cmd, nproc = calls.pop()
    assert nproc == 1 and cmd[cmd.index("--device") + 1] == "cuda"
    assert "--backend" not in cmd  # NCCL, init_distributed's default
    assert dryrun.main(["--device", "cpu"]) == 0
    cmd, nproc = calls.pop()
    assert nproc == 2 and cmd[cmd.index("--device") + 1] == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert dryrun.main([]) == 1
    assert not calls and "no CUDA device" in capsys.readouterr().err
