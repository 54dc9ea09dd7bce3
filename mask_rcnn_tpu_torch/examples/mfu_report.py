"""FLOPs and MFU of R-50/101-C4 at COCO scale on one card, the port of
``examples/mfu_report.py``.

Measures, for float32 and bfloat16: inference at batch 1
(``predict_step`` on a (1, 832, 1344, 3) image of original size 640x1066
at scale 1.25), the train forward loss at batch 2 and the full train step
at batch 2 (``make_train_step``, real consecutive steps), so the backward
pass's share is attributable. Device ms are the union of device activity
of a chained run (``utils/profiling.py``: ``time_fn_chained``,
``time_train_steps_chained``); events ms are CUDA events around
back-to-back calls (the host-paced time users feel). FLOPs come from
``cost_of``: torch's ``FlopCounterMode`` (padded border taps counted; XLA
leaves them out) plus the hand kernels' reports. MFU is taken against the
card's bf16 peak for both dtypes, as the JAX tool takes its chip's bf16
peak; a card that is not in ``ops/costs.py::CARDS`` gets MFU nan.

    python -m mask_rcnn_tpu_torch.examples.mfu_report \\
        [--batch 2] [--iters 10] [--layers 50]

Entry points run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mask_rcnn_tpu_torch.examples import _profile_common as common


def run(batch_size=2, iters=10, layers=50, device="cuda", batch=None,
        proposal_cfg=None, reps=20, step_reps=12, **overrides):
    """Prints the table; returns the rows. ``batch`` (numpy arrays)
    replaces the synthetic 832x1344 batch, ``proposal_cfg`` the sampler's
    defaults, ``overrides`` fields of the bench configuration (small CPU
    runs); ``reps`` and ``step_reps`` are the JAX script's chain lengths
    (20 calls, 12 steps)."""
    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch
    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params, predict_step
    from mask_rcnn_tpu_torch.models.targets import ProposalTargetConfig
    from mask_rcnn_tpu_torch.models.train_model import train_loss
    from mask_rcnn_tpu_torch.utils.profiling import time_train_steps_chained

    line, peaks = common.card(device)
    rng = np.random.RandomState(0)
    if batch is None:
        batch = make_synthetic_train_batch(batch_size, 832, 1344, rng)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    n, h, w = batch["image"].shape[:3]
    images1 = torch.from_numpy(
        (rng.randn(1, h, w, 3) * 60).astype(np.float32)).to(device)
    sizes1 = torch.tensor([[640.0, 1066.0]], device=device)
    scales1 = torch.tensor([1.25], device=device)
    p_cfg = proposal_cfg or ProposalTargetConfig()

    print(f"R-{layers}-C4 @ {h}x{w}; {line}")
    print(common.CONVENTIONS)
    print("MFU against the bf16 peak for both dtypes")
    print(f"{'stage':28s} {'device ms':>10s} {'events ms':>10s} "
          f"{'GFLOP':>9s} {'TFLOP/s':>8s} {'MFU':>6s} {'img/s':>7s}")
    rows = []

    def emit(row, imgs):
        tf, mfu = common.rates(row, peaks)[:2]
        print(f"{row['name']:28s} {row['device_ms']:10.3f} "
              f"{row['events_ms']:10.3f} {row['flops'] / 1e9:9.1f} "
              f"{tf:8.1f} {mfu:6.1%} {imgs / row['device_ms'] * 1e3:7.1f}",
              flush=True)
        rows.append(row)

    for dtype in ("float32", "bfloat16"):
        cfg = common.bench_config(dtype, layers, **overrides)
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        optimizer, _ = make_optimizer(params, 0.02, 1000)
        seed = 0

        def infer(img):
            return predict_step(params, cfg, img, sizes1, scales1)

        def fwd_loss(img):
            with torch.no_grad():
                return train_loss(
                    params, cfg, {**batch, "image": img},
                    torch.Generator(device=device).manual_seed(seed),
                    proposal_cfg=p_cfg)[0]

        with torch.no_grad():
            emit(common.measure(f"infer b1 {dtype}", infer, images1, reps,
                                iters), 1)
        emit(common.measure(f"train fwd-loss b{n} {dtype}", fwd_loss,
                            batch["image"], reps, iters), n)

        state = create_train_state(params, optimizer)
        step_fn = make_train_step(cfg, optimizer, proposal_cfg=p_cfg)

        def one_step(_):
            new, metrics = step_fn(state, batch, seed)
            state.step = new.step
            return metrics["loss"]

        emit(common.measure(
            f"train step b{n} {dtype}", one_step, batch["image"], reps, iters,
            lambda: time_train_steps_chained(step_fn, state, batch, seed,
                                             reps=step_reps, iters=iters)),
            n)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--layers", type=int, default=50, choices=(50, 101))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.batch, args.iters, args.layers, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
