"""One rank of the port's data-parallel tests (``tests/test_torch_multiprocess
.py``), started by ``mask_rcnn_tpu_torch.parallel.dryrun.launch`` (two gloo
ranks on the CPU through a ``FileStore``). Imports torch and the port only.

    python tests/torch_parallel_worker.py MODE IN_DIR OUT_DIR

``step``: the train step of ``tests/test_parallel.py::tiny_cfg`` on this
rank's row of the global batch in ``IN_DIR/inputs.npz``, 2 steps with the
given global priorities and 2 steps with the seeded generator, and step 1
with each rank's own loss averaged (the naive data parallelism that the
global denominators replace). ``train``: ``train()`` uninterrupted, and
interrupted at step 2 and resumed, 4 steps each; rank 1's writers raise.
``eval``: the evaluator pooled and averaged on the stub records of
:func:`eval_dataset`, an empty shard, and a failure on rank 1.
"""

import functools
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mask_rcnn_tpu_torch.engine import loop, trainer  # noqa: E402
from mask_rcnn_tpu_torch.models import mask_rcnn, rpn  # noqa: E402
from mask_rcnn_tpu_torch.models.targets import (  # noqa: E402
    AnchorTargetConfig,
    ProposalTargetConfig,
)
from mask_rcnn_tpu_torch.parallel import mesh  # noqa: E402
from mask_rcnn_tpu_torch.utils import checkpoint  # noqa: E402
from tests.test_engine import make_dataset  # noqa: E402

N_ROI_SAMPLE, N_ANCHOR_SAMPLE = 8, 16
LR, TOTAL_STEPS = 0.01, 10


def tiny_cfg():
    """``tests/test_parallel.py::tiny_cfg``."""
    return mask_rcnn.MaskRCNNConfig(
        n_fg_class=2, min_size=64, max_size=64, anchor_scales=(1.0, 2.0),
        proposal=rpn.ProposalConfig(n_train_pre_nms=64, n_train_post_nms=16,
                                    n_test_pre_nms=64, n_test_post_nms=16))


def step_kwargs():
    return dict(proposal_cfg=ProposalTargetConfig(n_sample=N_ROI_SAMPLE),
                anchor_cfg=AnchorTargetConfig(n_sample=N_ANCHOR_SAMPLE))


def run_steps(params_np, batch, rngs, wrap=None):
    """Train from ``params_np`` (flat numpy, the JAX layout) for one step
    per entry of ``rngs`` (a seed, or the global batch's priorities);
    returns the metrics and the params (flat numpy) after each step."""
    params = checkpoint.params_from_numpy(params_np)
    opt, _ = trainer.make_optimizer(params, LR, TOTAL_STEPS)
    state = trainer.create_train_state(params, opt)
    step = trainer.make_train_step(tiny_cfg(), opt, **step_kwargs())
    if wrap is not None:
        step = wrap(step)
    metrics, after = [], []
    for rng in rngs:
        state, m = step(state, batch, rng)
        metrics.append({k: float(v) for k, v in m.items()})
        # copies: the next step updates the params in place
        after.append({k: v.copy() for k, v in
                      checkpoint.params_to_numpy(state.params).items()})
    return metrics, after


def priorities_of(inputs, step):
    return {name: tuple(torch.from_numpy(inputs[f"{name}_{part}_{step}"])
                        for part in ("pos", "neg"))
            for name in ("proposal", "anchor")}


def run_step_mode(in_dir, out_dir, rank):
    inputs = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    params_np = {k[len("param/"):]: v for k, v in inputs.items()
                 if k.startswith("param/")}
    rows = mesh.local_batch_slice(2)
    batch = {k: torch.from_numpy(inputs[f"batch/{k}"][rows])
             for k in ("image", "bbox", "label", "bbox_valid", "mask",
                       "scale")}
    given = [priorities_of(inputs, s) for s in range(2)]
    out = {}
    for name, rngs in (("given", given), ("seeded", [1, 1])):
        m, after = run_steps(params_np, batch, rngs,
                             mesh.make_parallel_train_step)
        out[name] = m
        for s, p in enumerate(after):
            np.savez(os.path.join(
                out_dir, f"{name}_params_step{s}_rank{rank}.npz"), **p)
    # the naive form: each rank normalizes its own losses, and the ranks'
    # losses are averaged
    params = checkpoint.params_from_numpy(params_np)
    from mask_rcnn_tpu_torch.models.train_model import train_loss

    with torch.no_grad():
        _, m = train_loss(params, tiny_cfg(), batch,
                          {k: tuple(t[rows] for t in v)
                           for k, v in given[0].items()}, **step_kwargs())
        local = torch.stack([m[k] for k in sorted(m)])
        torch.distributed.all_reduce(local)
    out["naive"] = dict(zip(sorted(m), (local / 2).tolist()))
    return out


def train_cfg():
    """``tests/test_torch_loop.py::tiny_cfg``."""
    return mask_rcnn.MaskRCNNConfig(
        n_fg_class=1, min_size=64, max_size=64, anchor_scales=(1.0, 2.0),
        proposal=rpn.ProposalConfig(n_train_pre_nms=64, n_train_post_nms=16,
                                    n_test_pre_nms=64, n_test_post_nms=16),
        detections_per_im=4)


def run_train_mode(out_dir, rank):
    from mask_rcnn_tpu_torch.data import MaskRCNNTransform, TrainLoader

    loop.make_train_step = functools.partial(
        trainer.make_train_step, proposal_cfg=ProposalTargetConfig(
            n_sample=16), anchor_cfg=AnchorTargetConfig(n_sample=64))
    if rank != 0:
        # only rank 0 writes: every writer of train() raises elsewhere
        def refuse(*a, **k):
            raise AssertionError(f"rank {rank} wrote a file")

        for name in ("dump_params", "save_params", "save_train_state",
                     "plot_metrics"):
            setattr(loop, name, refuse)
        loop.LogReport.append = refuse
    ds = make_dataset(n=8)

    def loader():
        # the eval transform: the train transform's flips come from a
        # generator that the checkpoint does not hold
        return TrainLoader(
            ds, MaskRCNNTransform(64, 64, train_cfg().mean, train=False),
            batch_size=1, max_boxes=2, min_size=64, max_size=64,
            process_index=mesh.process_index(),
            process_count=mesh.process_count())

    kw = dict(max_epoch=1.0, log_interval=2, device="cpu")
    full, part, rest = (os.path.join(out_dir, d)
                        for d in ("full", "part", "rest"))
    res = [loop.train(train_cfg(), loader(), full, **kw),
           loop.train(train_cfg(), loader(), part, stop_at_step=2,
                      checkpoint_interval_steps=2, **kw),
           loop.train(train_cfg(), loader(), rest,
                      resume_from=os.path.join(part, "train_state"), **kw)]
    return {"iterations": [r["iterations"] for r in res]}


def eval_dataset(n, fail_at=None):
    """``n`` 40x52 images, each with 1-3 rectangle gts of 3 classes and
    its id in its first pixel, for :class:`StubModel`."""
    rng = np.random.RandomState(5)
    examples = []
    for i in range(n):
        img = np.zeros((40, 52, 3), np.uint8)
        img[0, 0, 0] = i
        g = rng.randint(1, 4)
        masks = np.zeros((g, 40, 52), bool)
        for k in range(g):
            y, x = rng.randint(0, 25), rng.randint(0, 35)
            masks[k, y:y + rng.randint(6, 15), x:x + rng.randint(6, 17)] = 1
        examples.append((img, np.zeros((g, 4), np.float32),
                         rng.randint(0, 3, g).astype(np.int32), masks))

    class DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            if i == fail_at:
                raise IOError(f"cannot read example {i}")
            return examples[i]

    return DS(), examples


class StubModel:
    """Detections that depend on the image only: the gts of the image
    whose id is in its first pixel, jittered, plus a spurious box, with
    scores from a generator seeded by the id; with ``ties`` the scores are
    rounded to 0.1, so that they tie across images."""

    def __init__(self, examples, ties=False):
        self.examples, self.ties = examples, ties

    def predict(self, imgs):
        out = ([], [], [], [])
        for img in imgs:
            i = int(img[0, 0, 0])
            _, _, labels, masks = self.examples[i]
            rng = np.random.RandomState(100 + i)
            det = np.roll(masks, rng.randint(-2, 3), axis=2)
            spurious = np.zeros((1,) + masks.shape[1:], bool)
            spurious[0, 30:38, 40:50] = True
            det = np.concatenate([det, spurious])
            lab = np.concatenate([labels, [rng.randint(0, 3)]])
            scores = rng.uniform(0.1, 1.0, len(det))
            if self.ties:
                scores = np.round(scores, 1)
            out[0].append(np.zeros((len(det), 4), np.float32))
            out[1].append(det)
            out[2].append(lab.astype(np.int32))
            out[3].append(scores.astype(np.float32))
        return out


EVAL_CLASSES = ("a", "b", "c")


def eval_cases():
    """(n images, tied scores, kind, pooled): 7 images make shards of 4
    and 3; with 1, rank 1's shard is empty."""
    return [(n, ties, kind, pool) for n in (7, 1) for ties in (False, True)
            for kind in ("coco", "voc") for pool in (True, False)]


def eval_key(n, ties, kind, pool):
    return (f"{kind}_{n}_{'ties' if ties else 'distinct'}_"
            f"{'pooled' if pool else 'averaged'}")


def run_eval_mode(rank):
    from mask_rcnn_tpu_torch.engine.evaluator import (
        InstanceSegmentationEvaluator,
    )

    out = {}
    for case in eval_cases():
        n, ties, kind, pool = case
        ds, examples = eval_dataset(n)
        out[eval_key(*case)] = InstanceSegmentationEvaluator(
            ds, EVAL_CLASSES, kind=kind, batch_size=2,
            pool_detections=pool)(StubModel(examples, ties))
    ds, examples = eval_dataset(4, fail_at=1)  # index 1 is rank 1's
    try:
        InstanceSegmentationEvaluator(ds, EVAL_CLASSES, kind="coco")(
            StubModel(examples))
        out["failure"] = None
    except RuntimeError as e:
        out["failure"] = str(e)
    return out


def main(mode, in_dir, out_dir):
    torch.set_num_threads(2)
    mesh.init_distributed("gloo", "cpu", timeout=100)
    try:
        rank = mesh.process_index()
        if mode == "step":
            res = run_step_mode(in_dir, out_dir, rank)
        elif mode == "train":
            res = run_train_mode(out_dir, rank)
        else:
            res = run_eval_mode(rank)
        with open(os.path.join(out_dir, f"{mode}_rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    finally:
        mesh.destroy_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:4])
