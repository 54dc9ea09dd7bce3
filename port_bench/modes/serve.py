"""What the serving modes share: the port's model built from the
configuration and its weights, the padded shape of a batch, the
sample of served images that the comparison judges, and the traced
segment's RoIAlign floor."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import check, counts, trace, weights
from port_bench.reference import model as R
from port_bench.traffic import rng


def port_config(model):
    from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig
    from mask_rcnn_tpu_torch.models.rpn import ProposalConfig

    return MaskRCNNConfig(
        n_fg_class=model["n_fg_class"], n_layers=model["n_layers"],
        min_size=model["min_size"], max_size=model["max_size"],
        ratios=tuple(model["ratios"]),
        anchor_scales=tuple(float(s) for s in model["anchor_scales"]),
        mean=tuple(model["mean"]), feat_stride=model["feat_stride"],
        rpn_hidden=model["rpn_hidden"], roi_size=model["roi_size"],
        mask_size=model["mask_size"], pooling=model["pooling"],
        sampling_ratio=model["sampling_ratio"],
        proposal=ProposalConfig(**model["proposal"]),
        loc_normalize_mean=tuple(model["loc_normalize_mean"]),
        loc_normalize_std=tuple(model["loc_normalize_std"]),
        nms_thresh=model["nms_thresh"], score_thresh=model["score_thresh"],
        detections_per_im=model["detections_per_im"],
        compute_dtype=model["compute_dtype"],
        nms_topk_per_class=model["nms_topk_per_class"])


def build_model(run):
    """``MaskRCNNResNet`` on the configuration's float32 weights; it casts
    them to the compute type once, at its first call."""
    from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet

    # The host's share of a request (prepare, the paste of each mask) is
    # many small CPU tensor operations: one thread a server process, as a
    # server of several processes runs them, and not a pool of threads
    # whose wake-ups moved the stream cell's rate by a quarter run to run.
    torch.set_num_threads(1)
    return MaskRCNNResNet.from_config(port_config(run.model),
                                      weights.of_config(run.cell.config,
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
        params = weights.of_config(run.cell.config, run.device)
        return check.serve_numbers(params, run.model, cases)


def roi_align_floor(run, shapes, dets_slots):
    """Seconds of K1's floor over batches of padded ``shapes`` (and their
    image counts): the proposals' call and the detections' call each."""
    dtype = run.model["compute_dtype"]
    total = 0
    for (h, w), n in shapes:
        hf, wf = h // run.model["feat_stride"], w // run.model["feat_stride"]
        for rois in (run.model["proposal"]["n_test_post_nms"], dets_slots):
            total += counts.roi_align_bytes(n, hf, wf, rois, run.model, dtype)
    return total / run.peaks["bytes_per_s"] if run.peaks else None


def k1_roofline(run, summary, shapes):
    """(floor seconds, K1 device seconds) of the traced segment; raises
    when the trace holds another number of K1 launches than the batches
    make."""
    seconds, launches = trace.kernel(summary, "roi_align_fwd_kernel")
    if launches != 2 * len(shapes):
        raise RuntimeError(f"traced {launches} RoIAlign launches for "
                           f"{len(shapes)} batches")
    return roi_align_floor(run, shapes, run.model["detections_per_im"]), \
        seconds
