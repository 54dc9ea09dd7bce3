"""The port's data parallelism in two processes: two gloo ranks on the CPU
(``tests/torch_parallel_worker.py``, started by
``mask_rcnn_tpu_torch.parallel.dryrun.launch`` through a ``FileStore``,
each launch bounded at 120 s) against one process.

* The train step of ``tests/test_parallel.py::tiny_cfg``: two ranks at
  batch 1 give one process's metrics and params at batch 2 (the bound of
  ``test_one_device_vs_eight_device_equality``), and the JAX package's
  2-device mesh step on the JAX-drawn priorities (the bounds of
  ``tests/test_torch_train.py::test_train_step_matches_jax_across_lr_drop``);
  averaging each rank's own normalized loss would not.
* ``train()`` on two ranks: rank 0 alone writes, and a resume is bit for
  bit.
* The evaluator: pooled reports equal one process's, averaged reports
  the JAX package's arithmetic, and a failure on one rank raises on both.
"""

import json
import os
import os.path as osp
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.engine import evaluator as jax_evaluator
from mask_rcnn_tpu.engine import trainer as jax_trainer
from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import targets as jax_targets
from mask_rcnn_tpu.parallel import make_mesh, make_parallel_train_step
from mask_rcnn_tpu.parallel import replicated, shard_batch
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.engine.evaluator import InstanceSegmentationEvaluator
from mask_rcnn_tpu_torch.parallel.dryrun import launch
from mask_rcnn_tpu_torch.utils import checkpoint
from tests import torch_parallel_worker as worker
from tests.test_parallel import tiny_cfg as jax_tiny_cfg
from tests.test_torch_train import jax_priorities

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT_S = 120
RTOL, ATOL = 5e-5, 1e-6  # test_one_device_vs_eight_device_equality's


def run_ranks(mode, tmp, in_dir=""):
    """Two ranks of ``mode``; returns their JSON results."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    launch([sys.executable, osp.join(REPO, "tests",
                                     "torch_parallel_worker.py"),
            mode, str(in_dir), str(tmp)], 2, TIMEOUT_S, env=env, cwd=REPO,
           log_dir=str(tmp))
    out = []
    for r in range(2):
        with open(osp.join(tmp, f"{mode}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def step_batch():
    """Two 64x64 images: one small gt, which only itself matches (one
    positive roi), and three large ones (the quota of positive rois), so
    the mask loss's counts differ between the ranks."""
    rng = np.random.RandomState(0)
    n, g = 2, 3
    batch = {
        "image": (rng.randn(n, 64, 64, 3) * 20).astype(np.float32),
        "bbox": np.zeros((n, g, 4), np.float32),
        "label": np.zeros((n, g), np.int32),
        "bbox_valid": np.zeros((n, g), bool),
        "mask": np.zeros((n, g, 64, 64), np.uint8),
        "scale": np.ones((n,), np.float32),
    }
    boxes = [[(10, 12, 18, 20)],
             [(4, 6, 30, 34), (20, 24, 58, 60), (36, 2, 60, 28)]]
    for i, bb in enumerate(boxes):
        for k, (y1, x1, y2, x2) in enumerate(bb):
            batch["bbox"][i, k] = (y1, x1, y2, x2)
            batch["label"][i, k] = k % 2
            batch["bbox_valid"][i, k] = True
            batch["mask"][i, k, y1:y2, x1:x2] = 1
    return batch


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The two-rank runs, the port at batch 2 in this process, and the
    JAX package's 2-device mesh, from the same params and batch."""
    tmp = tmp_path_factory.mktemp("dp_step")
    jcfg = jax_tiny_cfg()
    jparams = jax.device_get(jax_mrcnn.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    # The mask branch's bias at +3 for class 0 and -3 for class 1: the two
    # images' mean mask losses then differ (near log 2 each otherwise)
    jparams["head"]["mask"]["b"] = np.asarray([3.0, -3.0], np.float32)
    params_np = {k: np.array(v)
                 for k, v in jax_ckpt.flatten_params(jparams).items()}
    batch = step_batch()
    key = jax.random.PRNGKey(1)
    n_cand = jcfg.proposal.n_train_post_nms + batch["bbox"].shape[1]
    n_anchor = 4 * 4 * jcfg.n_anchor
    given = [jax_priorities(jax.random.fold_in(key, s), 2, n_cand,
                            n_anchor) for s in range(2)]
    inputs = {f"param/{k}": v for k, v in params_np.items()}
    inputs.update({f"batch/{k}": v for k, v in batch.items()})
    for s, pri in enumerate(given):
        for name, (pos, neg) in pri.items():
            inputs[f"{name}_pos_{s}"] = pos.numpy()
            inputs[f"{name}_neg_{s}"] = neg.numpy()
    np.savez(tmp / "inputs.npz", **inputs)
    ranks = run_ranks("step", tmp, tmp)

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = {name: worker.run_steps(params_np, tbatch, rngs)
           for name, rngs in (("given", given), ("seeded", [1, 1]))}

    optimizer, _ = jax_trainer.make_optimizer(jparams, base_lr=worker.LR,
                                              total_steps=worker.TOTAL_STEPS)
    step_fn = jax_trainer.make_train_step(
        jcfg, optimizer,
        proposal_cfg=jax_targets.ProposalTargetConfig(
            n_sample=worker.N_ROI_SAMPLE),
        anchor_cfg=jax_targets.AnchorTargetConfig(
            n_sample=worker.N_ANCHOR_SAMPLE))
    mesh = make_mesh(jax.devices()[:2])
    p_step = make_parallel_train_step(step_fn, mesh)
    # host copies: the jitted step donates its input state, whose buffers
    # may alias the arrays they were put from
    state = jax.device_put(jax_trainer.create_train_state(
        jax.tree_util.tree_map(np.array, jparams), optimizer),
        replicated(mesh))
    jax_metrics, jax_p = [], []
    for _ in range(2):
        state, m = p_step(state, shard_batch(batch, mesh),
                          jax.device_put(key, replicated(mesh)))
        jax_metrics.append({k: float(v) for k, v in
                            jax.device_get(m).items()})
        # copies: the next step donates (and reuses) these buffers
        jax_p.append({k: np.array(v) for k, v in jax_ckpt.flatten_params(
            jax.device_get(state.params)).items()})
    return dict(tmp=tmp, ranks=ranks, one=one, jax=(jax_metrics, jax_p),
                params0=params_np)


def rank_params(tmp, name, step, rank):
    return dict(np.load(osp.join(
        tmp, f"{name}_params_step{step}_rank{rank}.npz")))


@pytest.mark.parametrize("name", ["given", "seeded"])
def test_two_ranks_at_batch_1_match_one_process_at_batch_2(step_runs, name):
    """Given the global batch's priorities, or drawing them from each
    step's generator (each rank keeps its rows of the global draw)."""
    want_m, want_p = step_runs["one"][name]
    want_p = want_p[-1]
    got_m = step_runs["ranks"][0][name]
    assert step_runs["ranks"][1][name] == got_m  # the global metrics
    for g, w in zip(got_m, want_m):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    p0 = rank_params(step_runs["tmp"], name, 1, 0)
    p1 = rank_params(step_runs["tmp"], name, 1, 1)
    assert p0.keys() == want_p.keys()
    moved = 0
    for k, w in want_p.items():
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
        np.testing.assert_allclose(p0[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        moved += not np.array_equal(w, step_runs["params0"][k])
    assert moved > 20


def test_two_ranks_match_the_jax_two_device_mesh(step_runs):
    """The JAX package's ``make_parallel_train_step`` on a 2-device CPU
    mesh at batch 2; the ranks were given the priorities it draws. Both
    steps' metrics, and the params after the first step (from equal
    params, as in ``test_train_step_matches_jax_across_lr_drop``)."""
    jax_m, jax_p = step_runs["jax"]
    for g, w in zip(step_runs["ranks"][0]["given"], jax_m):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    got = rank_params(step_runs["tmp"], "given", 0, 0)
    p0 = step_runs["params0"]
    for k, w in jax_p[0].items():
        step_size = np.abs(w - p0[k]).max()
        ulp = np.finfo(np.float32).eps * np.abs(w).max()
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-3 * step_size + 4 * ulp,
                                   err_msg=k)


def test_global_denominators_differ_from_averaged_losses(step_runs):
    """The images' positive counts differ: each rank normalizing its own
    losses and averaging them misses the one-process loss, which the
    global denominators give."""
    naive = step_runs["ranks"][0]["naive"]
    want = step_runs["one"]["given"][0][0]
    got = step_runs["ranks"][0]["given"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    off = [k for k in want
           if not np.isclose(naive[k], want[k], rtol=RTOL, atol=ATOL)]
    assert {"loss", "roi_mask_loss"} <= set(off), (naive, want)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    return tmp, run_ranks("train", tmp)


def test_train_on_two_ranks_writes_on_rank_0_and_resumes_bit_for_bit(
        train_runs):
    tmp, ranks = train_runs
    for r in ranks:
        assert r["iterations"] == [4, 2, 4]
    with open(osp.join(tmp, "full", "params.yaml")) as f:
        params_yaml = json.load(f)
    assert params_yaml["n_devices"] == 2
    assert params_yaml["batch_size"] == 2
    assert params_yaml["lr"] == pytest.approx(0.00125 * 2)
    with open(osp.join(tmp, "full", "log")) as f:
        assert [e["iteration"] for e in json.load(f)] == [2, 4]
    with open(osp.join(tmp, "rest", "log")) as f:
        assert [e["iteration"] for e in json.load(f)] == [4]
    full = checkpoint.flatten_params(checkpoint.load_params(
        osp.join(tmp, "full", "snapshot_model.npz")))
    rest = checkpoint.flatten_params(checkpoint.load_params(
        osp.join(tmp, "rest", "snapshot_model.npz")))
    assert full.keys() == rest.keys()
    for k in full:
        assert torch.equal(full[k], rest[k]), k


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    return run_ranks("eval", tmp_path_factory.mktemp("dp_eval"))


class Subset:
    def __init__(self, ds, indices):
        self.ds, self.indices = ds, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]


def one_process(n, ties, kind, indices=None):
    ds, examples = worker.eval_dataset(n)
    if indices is not None:
        ds = Subset(ds, indices)
    return InstanceSegmentationEvaluator(
        ds, worker.EVAL_CLASSES, kind=kind, batch_size=2)(
            worker.StubModel(examples, ties))


@pytest.mark.parametrize("case", [c for c in worker.eval_cases() if c[3]],
                         ids=lambda c: worker.eval_key(*c))
def test_pooled_evaluation_equals_one_process(eval_runs, case):
    """The pooled records are the shards' in rank order: with distinct
    scores that is one process's report, with scores tied across images
    that of one process over the images in rank order (the JAX package's
    order too)."""
    n, ties, kind, _ = case
    got = [r[worker.eval_key(*case)] for r in eval_runs]
    assert got[0] == got[1]
    order = None
    if ties:
        order = list(range(n))[0::2] + list(range(n))[1::2]
    want = one_process(n, ties, kind, order)
    assert "validation/main/map" in want
    assert got[0] == want


@pytest.mark.parametrize("case",
                         [c for c in worker.eval_cases() if not c[3]],
                         ids=lambda c: worker.eval_key(*c))
def test_averaged_reports_follow_the_jax_arithmetic(eval_runs, case):
    """Each shard's one-process report, averaged as the JAX package's
    ``_aggregate_reports`` does (float32, NaN for an absent key); an empty
    shard reports no keys."""
    n, ties, kind, _ = case
    got = [r[worker.eval_key(*case)] for r in eval_runs]
    assert got[0] == got[1]
    shards = [one_process(n, ties, kind, range(n)[r::2]) for r in range(2)]
    if n == 1:
        assert shards[1] == {}
    jev = jax_evaluator.InstanceSegmentationEvaluator(
        None, worker.EVAL_CLASSES, kind=kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns
        mean = np.nanmean(np.stack([jev._report_to_vector(s)
                                    for s in shards]), axis=0)
    assert got[0] == jev._vector_to_report(mean)


def test_a_failure_on_one_rank_raises_on_both(eval_runs):
    for r in eval_runs:
        assert r["failure"] == "evaluation failed on process(es) [1]"


def test_dryrun_on_two_cpu_ranks(capfd, monkeypatch):
    """``python -m mask_rcnn_tpu_torch.parallel.dryrun --device cpu``: two
    gloo ranks take one step of the tiny configuration and agree."""
    from mask_rcnn_tpu_torch.parallel import dryrun

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.chdir(REPO)
    assert dryrun.main(["--nproc", "2", "--device", "cpu",
                        "--timeout", str(TIMEOUT_S)]) == 0
    out = capfd.readouterr().out
    assert "dryrun ok: 2 rank(s), backend gloo, device cpu" in out, out
