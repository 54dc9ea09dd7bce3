"""The serving and training paths under the alternate RoI poolers
(``MaskRCNNConfig.pooling`` = ``"resize"``, ``"pooling"``) against the JAX
package on the CPU in float32: ``predict_step`` with the configuration of
``tests/test_torch_models.py``, and ``train_loss`` metrics and every
gradient with the batch, configuration and JAX-drawn sampling priorities of
``tests/test_torch_train.py``, at those files' tolerances.

The JAX ``"pooling"`` path runs op by op: under ``jax.jit`` XLA turns
``roi_pool``'s ``extent / P`` into a multiply by the rounded reciprocal and
widens some bins (``tests/test_torch_pooling.py``); ``"resize"`` is
continuous in that step and runs jitted."""

import jax
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import rpn as jax_rpn
from mask_rcnn_tpu.models import targets as jax_targets
from mask_rcnn_tpu.models.train_model import train_loss as jax_train_loss
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.engine import trainer
from mask_rcnn_tpu_torch.models import mask_rcnn, rpn, targets
from mask_rcnn_tpu_torch.models.train_model import train_loss
from mask_rcnn_tpu_torch.utils import checkpoint
from tests import test_torch_models as models_fixture
from tests import test_torch_train as train_fixture

POOLERS = ["resize", "pooling"]


def jax_run(fn, pooling):
    return jax.jit(fn) if pooling == "resize" else fn


@pytest.mark.parametrize("pooling", POOLERS)
def test_predict_step_matches_jax(pooling):
    kw = models_fixture.tiny_kwargs()
    pkw = models_fixture.proposal_kwargs()
    jcfg = jax_mrcnn.MaskRCNNConfig(
        pooling=pooling, proposal=jax_rpn.ProposalConfig(**pkw), **kw)
    tcfg = mask_rcnn.MaskRCNNConfig(
        pooling=pooling, proposal=rpn.ProposalConfig(**pkw), **kw)
    jparams = jax_mrcnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = checkpoint.params_from_numpy(jax_ckpt.flatten_params(jparams))
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 96, 3).astype(np.float32) * 10
    sizes = np.array([[60.0, 90.0], [64.0, 96.0]], np.float32)
    scales = np.array([1.0, 0.9], np.float32)

    want = jax_run(
        lambda p, i, s, sc: jax_mrcnn.predict_step(p, jcfg, i, s, sc),
        pooling)(jparams, images, sizes, scales)
    with torch.no_grad():
        got = mask_rcnn.predict_step(
            tparams, tcfg, torch.from_numpy(images), torch.from_numpy(sizes),
            torch.from_numpy(scales))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].any()
    # the tolerances of tests/test_torch_models.py
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["mask_probs"], want["mask_probs"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("pooling", POOLERS)
def test_train_loss_metrics_and_grads_match_jax(pooling):
    kw = train_fixture.config_kwargs()
    pkw = train_fixture.proposal_kwargs()
    jcfg = jax_mrcnn.MaskRCNNConfig(
        pooling=pooling, proposal=jax_rpn.ProposalConfig(**pkw), **kw)
    tcfg = mask_rcnn.MaskRCNNConfig(
        pooling=pooling, proposal=rpn.ProposalConfig(**pkw), **kw)
    jparams = jax_mrcnn.init_params(jax.random.PRNGKey(7), jcfg)
    batch = train_fixture.golden_batch()
    n, h, w = batch["image"].shape[:3]
    n_anchor, n_roi = (train_fixture.N_ANCHOR_SAMPLE,
                       train_fixture.N_ROI_SAMPLE)
    key = jax.random.PRNGKey(4)

    value_and_grad = jax_run(jax.value_and_grad(
        lambda p, b, k: jax_train_loss(
            p, jcfg, b, k,
            anchor_cfg=jax_targets.AnchorTargetConfig(n_sample=n_anchor),
            proposal_cfg=jax_targets.ProposalTargetConfig(n_sample=n_roi)),
        has_aux=True), pooling)
    (_, want), jgrads = value_and_grad(jparams, batch, key)

    params = train_fixture.port_params(jparams)
    priorities = train_fixture.jax_priorities(
        key, n, jcfg.proposal.n_train_post_nms + batch["bbox"].shape[1],
        (h // 16) * (w // 16) * jcfg.n_anchor)
    loss, got = train_loss(
        params, tcfg, train_fixture.to_torch(batch), priorities,
        anchor_cfg=targets.AnchorTargetConfig(n_sample=n_anchor),
        proposal_cfg=targets.ProposalTargetConfig(n_sample=n_roi))
    for k in want:
        # float32 on both sides, sums in another order: 1e-4 relative
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(want["roi_mask_loss"]) > 0

    flat = checkpoint.flatten_params(params)
    names = sorted(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in names],
                                allow_unused=True)
    jflat = checkpoint.flatten_params(
        checkpoint.params_from_numpy(jax_ckpt.flatten_params(jgrads)))
    n_checked = 0
    for k, g in zip(names, grads):
        wk = jflat[k].numpy()
        if k.startswith("extractor/") and k.split("/")[1] in \
                trainer.FROZEN_STAGES:
            assert g is None and not wk.any(), k
            continue
        scale = np.abs(wk).max()
        assert scale > 0, k
        # float32 convs and matmuls summed in another order: 1e-3 of the
        # leaf's largest gradient (tests/test_torch_train.py)
        np.testing.assert_allclose(g.numpy(), wk, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
        n_checked += 1
    assert n_checked > 20
