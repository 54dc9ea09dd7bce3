"""Data parallelism over ``torch.distributed``, the port of
``mask_rcnn_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``Mesh`` of every device of every
process, and XLA inserts the gradient ``psum``. The port runs the torch
idiom instead: one process per device (``torchrun --nproc-per-node N``,
device ``cuda:{LOCAL_RANK}``), the default process group standing for the
global mesh:

  * ``make_parallel_train_step`` hands the step a :class:`DataParallel`
    hook: the step draws the global batch's sampling priorities and keeps
    its rows, divides each loss by its count over the global batch, and
    SUM-reduces the trainable gradients and the metrics, so N ranks at
    batch b give one process's result at batch N * b;
  * ``make_parallel_predict_step`` splits a batch over devices of this
    process and runs no collective;
  * ``process_zero`` gates writes, ``local_batch_slice`` slices a global
    batch per process.

Without an initialized group every helper here answers for one process
(index 0, count 1) and the train step runs unchanged: the single-process
path makes no ``torch.distributed`` call.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch

from mask_rcnn_tpu_torch.utils.checkpoint import (
    flatten_params,
    unflatten_params,
)

# The launcher of ``parallel/dryrun.py`` hands its ranks a ``file://``
# store through this variable; torchrun's ``env://`` is the default.
INIT_METHOD_ENV = "MASK_RCNN_TORCH_INIT_METHOD"
DEFAULT_TIMEOUT_S = 600.0


def is_distributed() -> bool:
    """True when a default process group is initialized."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank_and_world():
    if not is_distributed():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return _rank_and_world()[0]


def process_count() -> int:
    return _rank_and_world()[1]


def process_zero() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank; nothing to wait for in one process."""
    if is_distributed():
        import torch.distributed as dist

        dist.barrier()


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout: float = DEFAULT_TIMEOUT_S,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the default process group; returns this rank's device.

    The rank and world size come from ``RANK`` and ``WORLD_SIZE`` (torchrun
    sets them, so does ``dryrun.launch``). ``device`` defaults to
    ``cuda:{LOCAL_RANK}`` when a card is present, else the CPU; a bare
    ``"cuda"`` also takes ``LOCAL_RANK``'s card. ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU; one that this torch lacks
    raises, it is never swapped for another. ``timeout`` (seconds) bounds
    every collective, so a rank that dies leaves the others failing, not
    hanging. ``init_method`` defaults to ``$MASK_RCNN_TORCH_INIT_METHOD``,
    else ``env://`` (torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``).
    """
    import torch.distributed as dist

    env = os.environ
    if init_method is None:
        init_method = env.get(INIT_METHOD_ENV, "env://")
    needed = ["RANK", "WORLD_SIZE"]
    if init_method == "env://":
        needed += ["MASTER_ADDR", "MASTER_PORT"]
    missing = [k for k in needed if k not in env]
    if missing:
        raise RuntimeError(
            f"init_distributed: {', '.join(missing)} not set; start one "
            "process per device with `torchrun --nproc-per-node N ...` "
            "(or mask_rcnn_tpu_torch.parallel.dryrun's launcher)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", 0))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants {device}, but this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        # before any collective: NCCL and all_gather_object use it
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    available = {"nccl": dist.is_nccl_available,
                 "gloo": dist.is_gloo_available}
    if backend not in available or not available[backend]():
        raise RuntimeError(
            f"torch.distributed backend {backend!r} is not available here")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return device


def destroy_distributed() -> None:
    if is_distributed():
        import torch.distributed as dist

        dist.destroy_process_group()


def local_batch_slice(global_batch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """Deterministic per-process shard of a global batch. The batch must
    divide evenly: silently flooring would leave the remainder examples
    unassigned to any process."""
    rank, world = _rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(
            f"global batch {global_batch} does not divide over {pc} "
            f"processes — the last {global_batch % pc} example(s) would "
            "never be assigned to any host"
        )
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def _by_dtype(tensors: Sequence[torch.Tensor], collective) -> List:
    """Run ``collective`` on one flat buffer per dtype of ``tensors``;
    returns views of the buffers shaped like the inputs, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        pieces = torch.split(flat, [tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape)
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SUM of every rank's gradients, one all-reduce per dtype over a flat
    buffer (float32 for the master params), not one call per leaf."""
    import torch.distributed as dist

    return _by_dtype(list(grads), dist.all_reduce)


@torch.no_grad()
def broadcast_params(params, src: int = 0) -> None:
    """Overwrite every leaf of the nested dict ``params`` in place with
    rank ``src``'s values (one broadcast per dtype)."""
    if not is_distributed():
        return
    import torch.distributed as dist

    flat = flatten_params(params)
    leaves = [flat[k] for k in sorted(flat)]
    got = _by_dtype([t.detach() for t in leaves],
                    lambda flat: dist.broadcast(flat, src))
    for t, v in zip(leaves, got):
        t.copy_(v)


class DataParallel:
    """The hook ``make_train_step``'s step takes to act for one rank of a
    data-parallel global batch (``train_loss``'s ``data_parallel``):

      * ``rows(n)``: ``(offset, n_global)`` of this rank's ``n`` images in
        the global batch, so the step draws the global batch's sampling
        priorities and keeps its own rows;
      * ``all_reduce(t)``: the SUM over ranks of a small tensor (the
        losses' global counts, the metrics), in place;
      * ``all_reduce_grads(grads)``: the SUM of the gradients.
    """

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    @classmethod
    def current(cls) -> "DataParallel":
        return cls(process_index(), process_count())

    def rows(self, n: int):
        return self.rank * n, self.world_size * n

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t)
        return t

    def all_reduce_grads(self, grads):
        return all_reduce_grads(grads)


def make_parallel_train_step(step_fn):
    """``step_fn`` (from ``make_train_step``) run as one rank of the
    default process group: its batch is this rank's slice of the global
    batch, and ``rng`` (a seed, or the *global* batch's priorities) is the
    same on every rank. Params and velocities stay bit-identical across
    ranks, given identical starting values (``broadcast_params``). Without
    a group it is ``step_fn`` itself."""

    def p_step(state, batch, rng):
        if not is_distributed():
            return step_fn(state, batch, rng)
        return step_fn(state, batch, rng,
                       data_parallel=DataParallel.current())

    return p_step


def replicate_params(params, devices: Sequence) -> List:
    """One copy of the nested dict ``params`` on each of ``devices`` (the
    tree itself where its leaves already are)."""
    flat = flatten_params(params)
    out = []
    for d in devices:
        d = torch.device(d)
        if all(v.device == d for v in flat.values()):
            out.append(params)
        else:
            out.append(unflatten_params({k: v.to(d)
                                         for k, v in flat.items()}))
    return out


def make_parallel_predict_step(predict_fn, devices: Sequence):
    """``predict_fn(params, images, sizes, scales) -> dict`` over devices
    of this process; the step takes ``replicate_params(params, devices)``.
    The batch is padded to a multiple of ``len(devices)`` (pad rows: zero
    images of size 1 x 1 at scale 1), split in order, and each shard runs
    on its device; the outputs are concatenated on the first device with
    the pad rows dropped. No collective runs: each output row depends on
    its own input row only."""
    devices = [torch.device(d) for d in devices]

    def p_predict(replicas, images, sizes, scales):
        n, k = images.shape[0], len(devices)
        pad = -n % k
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad,) + tuple(images.shape[1:]))])
            sizes = torch.cat([sizes, sizes.new_ones((pad, 2))])
            scales = torch.cat([scales, scales.new_ones((pad,))])
        per = (n + pad) // k
        outs = [predict_fn(p, images[i * per:(i + 1) * per].to(d),
                           sizes[i * per:(i + 1) * per].to(d),
                           scales[i * per:(i + 1) * per].to(d))
                for i, (d, p) in enumerate(zip(devices, replicas))]
        return {key: torch.cat([o[key].to(devices[0]) for o in outs])[:n]
                for key in outs[0]}

    return p_predict
