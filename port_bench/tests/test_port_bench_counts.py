"""The analytic FLOP counts of ``archs/c4.py`` equal what torch's
``FlopCounterMode`` counts on the plain reference at a tiny size: a
predict step and a train step, forward and backward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import spec, traffic, weights
from port_bench.reference import model as R
from port_bench.reference import train as RT
from port_bench.tests import tiny

SEED = 77
C4 = spec.architecture(tiny.REPO, "c4")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("layers", [50, 101])
def test_predict_flops(layers):
    model = dict(tiny.MODEL, n_layers=layers)
    params = weights.make(C4, model, tiny.WEIGHTS, SEED, "cpu")
    h, w = 128, 192
    x = torch.zeros((1, 3, h, w))
    dets = 7
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        f, locs, scores, anchor = R.features(params, model, x, R.FULL)
        rois, _ = R.propose(model, locs, scores, anchor, (h, w))
        R.head(params["head"], model, f, rois, R.FULL)
        R.head(params["head"], model, f, rois[:dets], R.FULL, bbox=False,
               mask=True)
    assert len(rois) == model["proposal"]["n_test_post_nms"]
    assert fc.get_total_flops() == C4.predict_flops(model, h, w, 1, dets)


def test_train_flops():
    cfg = tiny.config()
    model = cfg["model"]
    batch = traffic.train_batches(tiny.TRAFFIC["tiny-train"], model, SEED,
                                  "cpu")[0]
    n, h, w = batch["image"].shape[:3]
    params = weights.make(C4, model, tiny.WEIGHTS, SEED, "cpu")
    flat = RT.flatten(params)
    names = [k for k in flat if RT.trainable(k)]
    for k in names:
        flat[k].requires_grad_(True)
    pri = traffic.priorities({}, SEED, 0, n, (h // 16) * (w // 16) * 9,
                             100 + batch["bbox"].shape[1], "cpu")
    with FlopCounterMode(display=False) as fc:
        loss, _ = RT.train_loss(params, cfg, batch, pri, R.FULL)
        torch.autograd.grad(loss, [flat[k] for k in names])
    assert fc.get_total_flops() == C4.train_flops(model, cfg["train"], h, w,
                                                   n)
