"""Optimizer, schedule and train step, the port of
``mask_rcnn_tpu/engine/trainer.py`` (reference examples/train_common.py):

  * MomentumSGD(momentum=0.9), WeightDecay(1e-4);
  * the learning rate times 0.1 at 120/180 and 160/180 of the schedule;
  * conv1, bn1, res2 and every ``bn*`` affine frozen: exactly zero update
    and no weight decay.

The update is written by hand, chainer-exact like the JAX package's optax
chain (decayed weights, scale by -lr, trace): the velocity accumulates
``-lr_t * (g + wd * w)``, so a LR drop does not rescale the velocity
already accumulated (``torch.optim.SGD`` applies lr after the trace, and
the two diverge at every drop).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig
from mask_rcnn_tpu_torch.models.targets import (
    AnchorTargetConfig,
    ProposalTargetConfig,
)
from mask_rcnn_tpu_torch.models.train_model import train_loss
from mask_rcnn_tpu_torch.utils import profiling
from mask_rcnn_tpu_torch.utils.checkpoint import (
    flatten_params,
    unflatten_params,
)

FROZEN_STAGES = ("conv1", "bn1", "res2")


def is_trainable(path) -> bool:
    """Reference freeze rules: extractor conv1/bn1/res2 and all folded-BN
    affines are frozen. ``path`` is a slash-joined name or a key
    sequence."""
    keys = path.split("/") if isinstance(path, str) else list(path)
    if keys[0] == "extractor" and keys[1] in FROZEN_STAGES:
        return False
    # Any bn* affine anywhere (extractor res3/4, head res5) is frozen.
    return not any(k.startswith("bn") for k in keys)


def trainable_mask(params):
    """The params' nested dict with a bool per leaf."""
    return unflatten_params(
        {k: is_trainable(k) for k in flatten_params(params)})


def step_lr_schedule(base_lr: float, total_steps: int,
                     milestones=(120 / 180, 160 / 180),
                     gamma: float = 0.1) -> Callable[[int], float]:
    """step -> lr, rounded to float32 at each drop as the JAX package's
    float32 schedule rounds it."""
    boundaries = [int(m * total_steps) for m in milestones]

    def schedule(step: int) -> float:
        lr = np.float32(base_lr)
        for b in boundaries:
            if step >= b:
                lr = np.float32(lr * np.float32(gamma))
        return float(lr)

    return schedule


@dataclasses.dataclass
class MomentumSGD:
    """Masked chainer MomentumSGD with weight decay and an optional global
    gradient-norm clip over the trainable leaves."""

    trainable: frozenset
    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_norm: Optional[float] = None

    def init(self, params):
        """Zero velocities for the trainable leaves, nested like params."""
        return unflatten_params({
            k: torch.zeros_like(v) for k, v in flatten_params(params).items()
            if k in self.trainable
        })

    @torch.no_grad()
    def apply(self, params, momentum, grads: Dict[str, torch.Tensor],
              step: int) -> None:
        """One update in place: ``v = -lr_t * (g + wd * w) + m * v;
        w = w + v`` for every trainable leaf; ``grads`` maps flat names to
        the leaves' float32 gradients."""
        flat_w = flatten_params(params)
        flat_v = flatten_params(momentum)
        names = sorted(self.trainable)
        w = [flat_w[k] for k in names]
        v = [flat_v[k] for k in names]
        g = [grads[k] for k in names]
        if self.clip_norm:
            # Not in the reference recipe (off by default, as in JAX).
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.clip_norm
            g = [torch.where(keep, x, x / norm * self.clip_norm) for x in g]
        # Each op rounds once, in the optax chain's order.
        u = torch._foreach_mul(w, self.weight_decay)
        torch._foreach_add_(u, g)
        torch._foreach_mul_(u, -self.schedule(step))
        torch._foreach_mul_(v, self.momentum)
        torch._foreach_add_(v, u)
        torch._foreach_add_(w, v)


def make_optimizer(params, base_lr: float, total_steps: int,
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   milestones=(120 / 180, 160 / 180),
                   clip_norm: Optional[float] = None):
    """Returns (optimizer, schedule), like the JAX package's."""
    schedule = step_lr_schedule(base_lr, total_steps, milestones)
    trainable = frozenset(k for k in flatten_params(params)
                          if is_trainable(k))
    return MomentumSGD(trainable, schedule, momentum, weight_decay,
                       clip_norm), schedule


@dataclasses.dataclass
class TrainState:
    """float32 master params, the velocities of the trainable leaves (both
    nested dicts of tensors) and the number of steps taken."""

    params: dict
    momentum: dict
    step: int = 0


def create_train_state(params, optimizer: MomentumSGD) -> TrainState:
    """A step-0 state; marks the trainable leaves as requiring grad."""
    for k, t in flatten_params(params).items():
        t.requires_grad_(k in optimizer.trainable)
    return TrainState(params, optimizer.init(params), 0)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s sampling generator (the JAX package
    folds the step into its key)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def make_train_step(cfg: MaskRCNNConfig, optimizer: MomentumSGD,
                    proposal_cfg=None, anchor_cfg=None):
    """Returns ``step_fn(state, batch, rng) -> (state, metrics)``.

    ``rng`` is an int seed (the step's generator is seeded from
    ``(rng, state.step)`` on the batch's device) or the priorities that
    :func:`train_loss` takes. ``data_parallel`` (given by
    ``parallel/mesh.py::make_parallel_train_step``) makes the step one
    rank's part of a global batch: ``rng`` then stands for the global
    batch, the losses are normalized over it, and the trainable gradients
    (so the clip norm) and the metrics are SUM-reduced over the ranks
    before the update. The step updates ``state.params`` and
    ``state.momentum`` in place under ``torch.no_grad()`` and returns a
    state that shares them, with the step incremented; the metrics are
    detached 0-d tensors on the device (reading them syncs the host).

    Spans (``utils/profiling.py``): ``mrcnn.train_step`` around the call,
    ``mrcnn.forward`` (``train_loss``), ``mrcnn.backward``
    (``autograd.grad``), ``mrcnn.all_reduce`` (both all-reduces, under
    ``data_parallel``) and ``mrcnn.update`` inside it, and
    ``mrcnn.first_call`` around a call whose padded image batch this
    process has not run.
    """
    p_cfg = proposal_cfg or ProposalTargetConfig()
    a_cfg = anchor_cfg or AnchorTargetConfig()

    def step(state: TrainState, batch, rng, data_parallel):
        if isinstance(rng, (int, np.integer)):
            dev = batch["image"].device
            rng = torch.Generator(device=dev).manual_seed(
                step_seed(int(rng), state.step))
        flat = flatten_params(state.params)
        names = sorted(optimizer.trainable)
        with profiling.span("mrcnn.forward"):
            loss, metrics = train_loss(state.params, cfg, batch, rng,
                                       anchor_cfg=a_cfg, proposal_cfg=p_cfg,
                                       data_parallel=data_parallel)
        with profiling.span("mrcnn.backward"):
            grads = torch.autograd.grad(loss, [flat[k] for k in names])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_parallel is not None:
            with profiling.span("mrcnn.all_reduce"):
                grads = data_parallel.all_reduce_grads(grads)
                summed = data_parallel.all_reduce(torch.stack(list(
                    metrics.values())))
            metrics = dict(zip(metrics, summed.unbind()))
        with profiling.span("mrcnn.update"):
            optimizer.apply(state.params, state.momentum,
                            dict(zip(names, grads)), state.step)
        return TrainState(state.params, state.momentum, state.step + 1), \
            metrics

    def step_fn(state: TrainState, batch, rng, data_parallel=None):
        image = batch["image"]
        with profiling.first_call(("train", *image.shape[:3], image.dtype)), \
                profiling.span("mrcnn.train_step"):
            return step(state, batch, rng, data_parallel)

    return step_fn
