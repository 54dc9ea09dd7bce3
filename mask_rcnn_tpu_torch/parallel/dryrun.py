"""Data-parallel dry run over ``torch.distributed``, the torch twin of
``__graft_entry__.py::dryrun_multichip``: one data-parallel train step of
a tiny configuration (64x64 images, one per rank), params broadcast from
rank 0, gradients all-reduced; prints the loss and checks that every rank
holds the same params after the step.

    python -m mask_rcnn_tpu_torch.parallel.dryrun   # NCCL, a rank a card
    python -m mask_rcnn_tpu_torch.parallel.dryrun --nproc 2 \\
        --device cuda:0 --backend gloo   # two ranks sharing one card
    python -m mask_rcnn_tpu_torch.parallel.dryrun --nproc 2 --device cpu

The ranks meet through a ``FileStore`` in a temporary directory (no TCP
port). :func:`launch` starts them; a rank that fails or outlives
``--timeout`` ends every rank, and the launcher exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from mask_rcnn_tpu_torch.parallel.mesh import INIT_METHOD_ENV


def launch(argv: Sequence[str], nproc: int, timeout: float,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
           log_dir: Optional[str] = None) -> None:
    """Run ``argv`` as ranks 0..nproc-1 of one process group and wait.

    Each rank gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and
    ``$MASK_RCNN_TORCH_INIT_METHOD`` (a ``file://`` store in a fresh
    temporary directory), on top of ``env`` (default: this process's).
    With ``log_dir`` each rank's output goes to ``rank{r}.out`` and
    ``rank{r}.err`` there, else to this process's. Raises
    ``RuntimeError`` when a rank exits non-zero or the ranks outlive
    ``timeout`` seconds; every rank still running is then killed.
    """
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory(prefix="mrcnn_dist_") as tmp:
        base[INIT_METHOD_ENV] = "file://" + os.path.join(tmp, "store")
        base["WORLD_SIZE"] = str(nproc)
        procs, files = [], []
        try:
            for rank in range(nproc):
                rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
                out = err = None
                if log_dir is not None:
                    out = open(os.path.join(log_dir, f"rank{rank}.out"), "w")
                    err = open(os.path.join(log_dir, f"rank{rank}.err"), "w")
                    files += [out, err]
                procs.append(subprocess.Popen(list(argv), env=rank_env,
                                              cwd=cwd, stdout=out,
                                              stderr=err))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank(s) {bad} of {nproc} failed (exit codes "
                        f"{[codes[r] for r in bad]})")
                if all(c == 0 for c in codes):
                    return
                if time.monotonic() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(
                        f"rank(s) {running} of {nproc} still running after "
                        f"{timeout:g} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in files:
                f.close()


def tiny_config():
    """``dryrun_multichip``'s configuration."""
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    from mask_rcnn_tpu_torch.models.rpn import ProposalConfig

    return MaskRCNNConfig(
        n_fg_class=3, n_layers=50, min_size=64, max_size=64,
        anchor_scales=(1.0, 2.0),  # 16/32px anchors fit the 64px images
        ratios=(1.0,),
        proposal=ProposalConfig(n_train_pre_nms=64, n_train_post_nms=16,
                                n_test_pre_nms=64, n_test_post_nms=16),
    )


def rank_main(device: str, backend: Optional[str], timeout: float) -> None:
    """One rank of the dry run (under :func:`launch` or torchrun)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
    )
    from mask_rcnn_tpu_torch.parallel.mesh import (
        broadcast_params,
        destroy_distributed,
        init_distributed,
        local_batch_slice,
        make_parallel_train_step,
        process_count,
        process_index,
    )
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    dev = init_distributed(backend, device, timeout=timeout)
    try:
        rank, world = process_index(), process_count()
        cfg = tiny_config()
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        opt, _ = make_optimizer(params, base_lr=0.02, total_steps=100)
        state = create_train_state(params, opt)
        broadcast_params(state.params)
        step = make_parallel_train_step(make_train_step(
            cfg, opt, proposal_cfg=ProposalTargetConfig(n_sample=8),
            anchor_cfg=AnchorTargetConfig(n_sample=16)))

        n = world  # one image per rank
        rng = np.random.RandomState(0)
        batch = {
            "image": rng.randn(n, 64, 64, 3).astype(np.float32),
            "bbox": np.tile(np.asarray([[[8.0, 8.0, 40.0, 40.0]]],
                                       np.float32), (n, 1, 1)),
            "label": np.zeros((n, 1), np.int32),
            "bbox_valid": np.ones((n, 1), bool),
            "mask": np.ones((n, 1, 64, 64), np.uint8),
            "scale": np.ones((n,), np.float32),
        }
        rows = local_batch_slice(n)
        local = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in batch.items()}
        state, metrics = step(state, local, 1)
        metrics = {k: float(v) for k, v in metrics.items()}
        assert np.isfinite(metrics["loss"]), metrics
        assert state.step == 1
        # every rank must hold rank 0's params after the step
        flat = flatten_params(state.params)
        digest = [float(flat[k].detach().double().sum())
                  for k in sorted(flat)]
        sums = [None] * world
        dist.all_gather_object(sums, digest)
        assert all(s == sums[0] for s in sums), "ranks' params differ"
        if rank == 0:
            print(f"dryrun ok: {world} rank(s), backend "
                  f"{dist.get_backend()}, device {dev}, "
                  f"loss={metrics['loss']:.4f}, metrics="
                  f"{ {k: round(v, 4) for k, v in metrics.items()} }",
                  flush=True)
    finally:
        destroy_distributed()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: one a card; 2 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: cuda:{LOCAL_RANK}), cuda:N (every "
                    "rank on card N) or cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds before the launcher ends every rank")
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank (the launcher passes this)")
    a = ap.parse_args(argv)
    if a.rank:
        rank_main(a.device, a.backend, a.timeout)
        return 0
    cmd = [sys.executable, "-m", "mask_rcnn_tpu_torch.parallel.dryrun",
           "--rank", "--device", a.device, "--timeout", str(a.timeout)]
    if a.backend:
        cmd += ["--backend", a.backend]
    nproc = a.nproc
    if nproc is None:
        import torch

        nproc = 2 if a.device == "cpu" else torch.cuda.device_count()
        if nproc == 0:
            print("dryrun failed: no CUDA device (--device cpu runs on the "
                  "CPU)", file=sys.stderr)
            return 1
    try:
        launch(cmd, nproc, a.timeout)
    except RuntimeError as e:
        print(f"dryrun failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
