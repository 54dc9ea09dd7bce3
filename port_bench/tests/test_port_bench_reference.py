"""The plain reference agrees with the port's plain CPU path at a tiny
size: the same detections and masks from the same images and weights, and
the same losses, first gradient and weights after two train steps from the
same batches and priorities."""

import numpy as np
import pytest
import torch

from port_bench import spec, traffic, weights
from port_bench.reference import model as R
from port_bench.reference import train as RT
from port_bench.tests import tiny

SEED = 12345678901
C4 = spec.architecture(tiny.REPO, "c4")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_weights_have_the_ports_layout():
    from mask_rcnn_tpu_torch.models.mask_rcnn import init_params
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    cfg = C4.port_config(tiny.MODEL)
    with torch.device("meta"):
        theirs = flatten_params(init_params(cfg, torch.Generator(), "meta"))
    ours = flatten_params(weights.make(C4, tiny.MODEL, tiny.WEIGHTS, SEED,
                                       "cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}


def test_inference_matches_the_port():
    from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet

    params = weights.make(C4, tiny.MODEL, tiny.WEIGHTS, SEED, "cpu")
    api = MaskRCNNResNet.from_config(C4.port_config(tiny.MODEL), params,
                                     device="cpu")
    imgs = traffic.serve_batches(tiny.TRAFFIC["tiny-stream"], SEED, "cpu")[0]
    boxes, masks, labels, scores = api.predict(imgs)
    shape = R.batch_shape(tiny.MODEL, [im.shape[1:] for im in imgs])
    with torch.no_grad():
        for i, img in enumerate(imgs):
            d = R.detect(params, tiny.MODEL, img, shape, R.FULL, "cpu")
            assert len(boxes[i]) == len(d["boxes"]) > 0
            np.testing.assert_array_equal(labels[i], d["labels"].numpy())
            np.testing.assert_allclose(boxes[i], d["boxes"].numpy(),
                                       atol=1e-3)
            np.testing.assert_allclose(scores[i], d["scores"].numpy(),
                                       atol=1e-5)
            probs = R.mask_probs(params, tiny.MODEL, d["features"],
                                 torch.as_tensor(boxes[i]),
                                 torch.as_tensor(labels[i]), d["scale"],
                                 R.FULL)
            pasted = R.paste(boxes[i], probs.numpy(), *img.shape[1:])
            assert np.count_nonzero(pasted != masks[i]) <= 2


def test_train_steps_match_the_port():
    from mask_rcnn_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from mask_rcnn_tpu_torch.models.targets import (
        AnchorTargetConfig,
        ProposalTargetConfig,
    )
    from mask_rcnn_tpu_torch.utils.checkpoint import flatten_params

    cfg = tiny.config()
    tr = cfg["train"]
    batches = traffic.train_batches(tiny.TRAFFIC["tiny-train"], tiny.MODEL,
                                    SEED, "cpu")[:2]

    def pri(k, b):
        n, h, w = b["image"].shape[:3]
        return traffic.priorities({}, SEED, k, n, (h // 16) * (w // 16) * 9,
                                  100 + b["bbox"].shape[1], "cpu")

    params = weights.make(C4, tiny.MODEL, tiny.WEIGHTS, SEED, "cpu")
    opt, _ = make_optimizer(params, tr["lr"], tr["total_steps"])
    state = create_train_state(params, opt)
    step = make_train_step(
        C4.port_config(tiny.MODEL), opt,
        proposal_cfg=ProposalTargetConfig(**tr["proposal_target"]),
        anchor_cfg=AnchorTargetConfig(**tr["anchor_target"]))
    theirs = []
    for k, b in enumerate(batches):
        state, met = step(state, b, pri(k, b))
        theirs.append({n: float(v) for n, v in met.items()})
        if k == 0:
            v1 = {n: v.clone() for n, v in
                  flatten_params(state.momentum).items()}
    from port_bench import check

    ours, g1, w2 = check.reference_steps(
        C4, cfg, weights.make(C4, tiny.MODEL, tiny.WEIGHTS, SEED, "cpu"),
        batches, [pri(k, b) for k, b in enumerate(batches)])
    for a, b in zip(theirs, ours):
        for term in RT.TERMS:
            assert a[term] == pytest.approx(b[term], rel=1e-4, abs=1e-6)
    w0 = RT.flatten(weights.make(C4, tiny.MODEL, tiny.WEIGHTS, SEED, "cpu"))
    assert set(v1) == set(g1)
    for n in g1:
        g = v1[n] / -tr["lr"] - tr["weight_decay"] * w0[n]
        assert float((g - g1[n]).norm()) <= 1e-3 * float(g1[n].norm()) + 1e-6
        got = flatten_params(state.params)[n]
        assert float((got - w2[n]).abs().max()) < 1e-5
