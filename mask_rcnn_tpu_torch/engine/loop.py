"""End-to-end training, one process per device, the port of
``mask_rcnn_tpu/engine/loop.py::train`` and ``_evaluate`` (the reference's
examples/train_common.py).

Carried over: derived LR (0.00125 * batch), step decay at 120/180 and
160/180, ``params.yaml`` (as JSON) and the JSON ``log`` in ``out_dir``,
losses accumulated on the device and read only at log time, a final flush
of a part interval, periodic evaluation, the best-mAP ``snapshot_model.npz``
(the JAX package's npz layout), ``checkpoint_interval_steps`` and
``stop_at_step``, and a resume that replays the uninterrupted run's data
(``TrainLoader.position_for_step`` / ``epoch(skip=...)``) and sampling
(each step's generator is seeded from ``(seed, step)``,
``trainer.step_seed``).

``pretrained_model`` takes every spec of
``models/api.py::resolve_pretrained_params`` (ImageNet 'auto', Detectron
pkl, chainer snapshot, bridge npz). Data parallelism is the default
process group's (``parallel/mesh.py``; the JAX package's global mesh):
each rank feeds its slice of the global batch, the params start from rank
0's, and only rank 0 writes, the visualization report's tiles
(``vis_report``) included.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from dataclasses import asdict
from typing import Dict, Optional

import numpy as np
import torch

from mask_rcnn_tpu_torch.engine.evaluator import (
    InstanceSegmentationEvaluator,
    VisReport,
)
from mask_rcnn_tpu_torch.engine.trainer import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from mask_rcnn_tpu_torch.models.api import (
    MaskRCNNResNet,
    resolve_pretrained_params,
)
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, init_params
from mask_rcnn_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_params,
    make_parallel_train_step,
    process_count,
    process_index,
    process_zero,
)
from mask_rcnn_tpu_torch.utils.checkpoint import (
    restore_train_state,
    save_params,
    save_train_state,
)
from mask_rcnn_tpu_torch.utils.logging import (
    LogReport,
    dump_params,
    plot_metrics,
)


def upload_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A padded numpy batch (``pad_batch``) -> tensors on ``device`` (pinned
    memory and asynchronous copies on a GPU)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def train(
    cfg: MaskRCNNConfig,
    train_loader,
    out_dir: str,
    max_epoch: float,
    batch_size_per_device: Optional[int] = None,
    evaluator: Optional[InstanceSegmentationEvaluator] = None,
    vis_report: Optional[VisReport] = None,
    eval_interval_epochs: float = 1.0,
    log_interval: int = 20,
    seed: int = 0,
    lr: Optional[float] = None,
    extra_params: Optional[Dict] = None,
    resume_from: Optional[str] = None,
    checkpoint_interval_steps: Optional[int] = None,
    clip_norm: Optional[float] = None,
    initializer: str = "normal",
    pretrained_model: Optional[str] = None,
    stop_at_step: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Run the training schedule on this process's device (the card unless
    ``device`` says otherwise), as one rank of the default process group
    when there is one; returns ``{"best_map", "iterations", "elapsed"}``.

    ``batch_size_per_device`` defaults to the loader's batch, which is
    this process's: one process drives one device, so a loader batch of
    several devices raises (start one process per device with
    ``torchrun``). The global batch is ``batch_size_per_device`` times the
    world size, and the loader must slice it per process
    (``TrainLoader(process_index=, process_count=)``). Every rank
    evaluates its shard; rank 0 alone writes ``params.yaml``, the log and
    its plots, the checkpoints and the snapshots, and after each
    evaluation draws ``vis_report``'s tile. ``pretrained_model``
    takes the specs of ``resolve_pretrained_params`` ('auto' keeps the RPN
    and branch values drawn from ``seed`` with ``initializer``).
    ``resume_from`` is a ``train_state`` directory that
    ``checkpoint_interval_steps`` wrote.
    """
    device = torch.device(device)
    per_device = batch_size_per_device or train_loader.batch_size
    if (train_loader.batch_size % per_device != 0
            or train_loader.batch_size < per_device):
        raise ValueError(
            f"loader batch_size ({train_loader.batch_size}) must be a "
            f"multiple of batch_size_per_device ({per_device})")
    n_local = train_loader.batch_size // per_device
    if n_local != 1:
        raise ValueError(
            f"batch {train_loader.batch_size} at {per_device} per device "
            f"needs {n_local} devices in this process; the port drives one "
            f"device a process: start {n_local} processes with `torchrun "
            f"--nproc-per-node {n_local}`, each with a loader batch of "
            f"{per_device}")
    rank, n_devices = process_index(), process_count()
    shard = (getattr(train_loader, "process_index", 0),
             getattr(train_loader, "process_count", 1))
    if shard != (rank, n_devices):
        raise ValueError(
            f"rank {rank} of {n_devices} has a loader for process "
            f"{shard[0]} of {shard[1]}: build it with process_index="
            f"{rank}, process_count={n_devices}")
    global_batch = per_device * n_devices
    base_lr = lr if lr is not None else 0.00125 * global_batch

    steps_per_epoch = train_loader.steps_per_epoch()
    total_steps = int(max_epoch * steps_per_epoch)
    if total_steps <= 0:
        raise ValueError(
            f"no training steps: steps_per_epoch={steps_per_epoch} at "
            f"batch {train_loader.batch_size} x max_epoch={max_epoch}")
    # The LR schedule spans the whole max_epoch run; stop_at_step only
    # interrupts it (to checkpoint and resume later).
    stop_step = min(stop_at_step or total_steps, total_steps)

    params = init_params(cfg, torch.Generator().manual_seed(seed), device,
                         initializer=initializer)
    if pretrained_model:
        params = resolve_pretrained_params(pretrained_model, params, cfg,
                                           device)
    optimizer, schedule = make_optimizer(params, base_lr, total_steps,
                                         clip_norm=clip_norm)
    step_fn = make_parallel_train_step(make_train_step(cfg, optimizer))
    state = create_train_state(params, optimizer)
    if resume_from:
        state = restore_train_state(resume_from, state)
        print(f"resumed from {resume_from} at step {state.step}")
    # Every rank starts from rank 0's params and velocities.
    broadcast_params(state.params)
    broadcast_params(state.momentum)

    log = LogReport(out_dir)
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        dump_params(out_dir, {
            "model_config": asdict(cfg),
            "batch_size": global_batch,
            "lr": base_lr,
            "max_epoch": max_epoch,
            "seed": seed,
            "n_devices": n_devices,
            "device": str(device),
            **(extra_params or {}),
        })

    best_map = -1.0
    it = state.step
    t_start = time.time()
    running: Dict[str, torch.Tensor] = {}
    running_n = 0  # steps accumulated since the last flush (a resume can
    # land mid-interval)
    # Restart at the epoch and batch the restored step had reached: the
    # epoch's shuffle is a function of (seed, epoch), so the resumed run
    # sees the uninterrupted run's batches.
    epoch, skip = train_loader.position_for_step(it)
    last_step_epoch = epoch
    eval_every = max(int(eval_interval_epochs * steps_per_epoch), 1)

    def flush(at_epoch):
        entry = {"epoch": at_epoch, "iteration": it,
                 "elapsed_time": time.time() - t_start,
                 "lr": schedule(it)}
        entry.update({"main/" + k: float(v) / running_n
                      for k, v in running.items()})
        log.append(entry)
        return entry

    while it < stop_step:
        for batch in train_loader.epoch(epoch, skip=skip):
            if it >= stop_step:
                break
            state, metrics = step_fn(state, upload_batch(batch, device), seed)
            it += 1
            last_step_epoch = epoch
            # accumulated on the device (the global batch's, on every
            # rank); read only when logged
            for k, v in metrics.items():
                running[k] = running[k] + v if k in running else v
            running_n += 1
            if it % log_interval == 0:
                if rank == 0:
                    entry = flush(epoch)
                    print(f"[it {it}/{total_steps}] " + " ".join(
                        f"{k.split('/')[-1]}={v:.4f}"
                        for k, v in entry.items() if k.startswith("main/")))
                running, running_n = {}, 0

            if checkpoint_interval_steps and \
                    it % checkpoint_interval_steps == 0:
                if rank == 0:
                    save_train_state(osp.join(out_dir, "train_state"), state)
                barrier()  # a resume on any rank reads a whole file

            if evaluator is not None and it % eval_every == 0:
                # every rank scores its shard; the report is the global one
                report = _evaluate(cfg, state, evaluator, vis_report, it,
                                   device)
                cur = report.get("validation/main/map", -1)
                if cur > best_map:
                    best_map = cur
                    if rank == 0:
                        save_params(osp.join(out_dir, "snapshot_model.npz"),
                                    state.params)
                if rank == 0:
                    entry = {"epoch": epoch, "iteration": it}
                    entry.update(report)
                    log.append(entry)
                    plot_metrics(out_dir, log.entries,
                                 [f"main/{k}" for k in (
                                     "loss", "roi_mask_loss",
                                     "rpn_cls_loss")], "loss.png")
                    plot_metrics(out_dir, log.entries,
                                 ["validation/main/map"], "accuracy.png")
        skip = 0
        epoch += 1

    # Flush a part interval, stamped with the epoch its steps ran in.
    if running_n and rank == 0:
        flush(last_step_epoch)
    # A run that never evaluated, or never scored above 0, still leaves
    # its last params.
    if best_map <= 0 and rank == 0:
        save_params(osp.join(out_dir, "snapshot_model.npz"), state.params)
    barrier()  # every rank returns with rank 0's files written
    return {"best_map": best_map, "iterations": it,
            "elapsed": time.time() - t_start}


def _evaluate(cfg, state, evaluator, vis_report, iteration, device):
    """Score the in-training params: a model over the float32 masters (cast
    to the compute dtype once per evaluation). After the (pooled)
    evaluation rank 0 draws the visualization at the report's score
    threshold, then restores the evaluation's 0.05."""
    model = MaskRCNNResNet.from_config(cfg, state.params, device=device)
    report = evaluator(model)
    if vis_report is not None and process_zero():
        model.score_thresh = vis_report.score_thresh
        vis_report(model, iteration)
        model.score_thresh = 0.05
    return report
