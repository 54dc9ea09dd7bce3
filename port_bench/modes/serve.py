"""What the serving modes share: the port's model built from the
configuration and its weights, the padded shape of a batch, and the
sample of served images that the comparison judges."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import check, weights
from port_bench.reference import model as R
from port_bench.traffic import rng


def build_model(run):
    """``MaskRCNNResNet`` on the configuration's float32 weights; it casts
    them to the compute type once, at its first call."""
    from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet

    # The host's share of a request (prepare, the paste of each mask) is
    # many small CPU tensor operations: one thread a server process, as a
    # server of several processes runs them, and not a pool of threads
    # whose wake-ups moved the stream cell's rate by a quarter run to run.
    torch.set_num_threads(1)
    arch = run.cell.arch
    return MaskRCNNResNet.from_config(arch.port_config(run.model),
                                      weights.of_config(arch, run.cell.config,
                                                        run.device),
                                      device=run.device)


def padded(model, batch):
    return R.batch_shape(model, [im.shape[1:] for im in batch])


def warm(model_api, batches, shapes):
    """One call for each padded shape that the traffic uses."""
    seen = set()
    for b, s in zip(batches, shapes):
        if s not in seen:
            seen.add(s)
            model_api.predict(b)


def finite_result(res):
    """Every box and score finite: ``res`` is ``predict``'s or
    ``predict_collect_raw``'s tuple (boxes first, scores fourth)."""
    boxes, scores = res[0], res[3]
    return all(np.isfinite(b).all() for b in boxes) and all(
        np.isfinite(s).all() for s in scores)


def sample_cases(run, served):
    """The images the comparison judges: the one with the most detections
    and, drawn from the seed, the rest of the traffic's ``check_images``.
    ``served`` maps (pool batch, image) -> (image, padded shape, result)."""
    keys = sorted(served)
    if not keys:
        return []
    most = max(keys, key=lambda k: len(served[k][2][0]))
    rest = [k for k in keys if k != most]
    n = min(run.cell.traffic["check_images"] - 1, len(rest))
    pick = [rest[i] for i in rng(run.seed, 7).choice(len(rest), n,
                                                     replace=False)]
    return [served[k] for k in [most] + sorted(pick)]


def per_image(res, i):
    return tuple(part[i] for part in res)


def compare(run, cases):
    R.full_precision()
    with torch.no_grad():
        params = weights.of_config(run.cell.arch, run.cell.config,
                                   run.device)
        return check.serve_numbers(run.cell.arch, params, run.model, cases)
