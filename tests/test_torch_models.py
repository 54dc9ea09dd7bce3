"""The port's models (``mask_rcnn_tpu_torch.models``) against the JAX
package on the CPU in float32, with the same parameters (through the
parameter bridge) and the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import heads as jax_heads
from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import rpn as jax_rpn
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.models import heads, mask_rcnn, rpn
from mask_rcnn_tpu_torch.utils import checkpoint
from tests.oracles import random_boxes


def tiny_kwargs():
    """The tiny configuration of tests/test_model.py::tiny_config."""
    return dict(
        n_fg_class=3, n_layers=50, min_size=64, max_size=96,
        anchor_scales=(1.0, 2.0), detections_per_im=8,
    )


def proposal_kwargs():
    return dict(n_train_pre_nms=120, n_train_post_nms=40,
                n_test_pre_nms=80, n_test_post_nms=24)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_mrcnn.MaskRCNNConfig(
        proposal=jax_rpn.ProposalConfig(**proposal_kwargs()), **tiny_kwargs()
    )
    tcfg = mask_rcnn.MaskRCNNConfig(
        proposal=rpn.ProposalConfig(**proposal_kwargs()), **tiny_kwargs()
    )
    jparams = jax_mrcnn.init_params(jax.random.PRNGKey(0), jcfg)
    flat = jax_ckpt.flatten_params(jparams)
    tparams = checkpoint.params_from_numpy(flat)
    return jcfg, jparams, tcfg, tparams


def test_param_bridge_round_trip_is_exact(models, tmp_path):
    _, jparams, _, tparams = models
    flat = jax_ckpt.flatten_params(jparams)
    back = checkpoint.params_to_numpy(tparams)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    # layouts the port's functional ops take
    ex = tparams["extractor"]
    assert tuple(ex["conv1"]["W"].shape) == (64, 3, 7, 7)  # OIHW
    assert tuple(tparams["head"]["deconv6"]["W"].shape) == (2048, 256, 2, 2)
    assert tuple(tparams["head"]["cls_loc"]["W"].shape) == (2048, 16)

    # the npz either package writes, read by the other
    path = str(tmp_path / "p.npz")
    checkpoint.save_params(path, tparams)
    loaded = jax_ckpt.load_params(path, jparams)
    for k, v in jax_ckpt.flatten_params(loaded).items():
        np.testing.assert_array_equal(v, flat[k])
    jax_ckpt.save_params(path, jparams)
    again = checkpoint.flatten_params(checkpoint.load_params(path))
    for k, v in checkpoint.flatten_params(tparams).items():
        assert torch.equal(again[k], v), k


def test_init_params_matches_jax_tree_and_scales(models):
    jcfg, jparams, tcfg, _ = models
    mine = checkpoint.params_to_numpy(
        mask_rcnn.init_params(tcfg, torch.Generator().manual_seed(0))
    )
    want = jax_ckpt.flatten_params(jparams)
    assert set(mine) == set(want)
    for k, v in want.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
        if k.endswith(("scale", "bias", "/b")):
            np.testing.assert_array_equal(mine[k], v)  # constants
        elif v.size > 4096:  # same distribution, not the same bits
            np.testing.assert_allclose(mine[k].std(), v.std(), rtol=0.1)


def test_backbone_rpn_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 96, 3).astype(np.float32) * 10
    want = jax_mrcnn.forward_backbone_rpn(jparams, jcfg, jnp.asarray(images))
    with torch.no_grad():
        got = mask_rcnn.forward_backbone_rpn(tparams, tcfg,
                                             torch.from_numpy(images))
    for g, w, name in zip(got, want, ("feats", "locs", "scores", "anchors")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_head_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 4, 6, 1024).astype(np.float32)
    rois = np.stack([random_boxes(rng, 5, 64, 96, min_size=4)
                     for _ in range(2)])
    want = jax_heads.head_forward(
        jparams["head"], jnp.asarray(feats), jnp.asarray(rois), None,
        roi_size=14, spatial_scale=1 / 16,
    )
    with torch.no_grad():
        got = heads.head_forward(tparams["head"], torch.from_numpy(feats),
                                 torch.from_numpy(rois), roi_size=14,
                                 spatial_scale=1 / 16)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("uint8", [False, True])
def test_predict_step_matches_jax(models, uint8):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(0)
    n, h, w = 2, 64, 96
    if uint8:
        images = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    else:
        images = rng.randn(n, h, w, 3).astype(np.float32) * 10
    sizes = np.array([[60.0, 90.0], [64.0, 96.0]], np.float32)
    scales = np.array([1.0, 0.9], np.float32)

    want = jax.jit(
        lambda p, i, s, sc: jax_mrcnn.predict_step(p, jcfg, i, s, sc)
    )(jparams, images, sizes, scales)
    with torch.no_grad():
        got = mask_rcnn.predict_step(
            tparams, tcfg, torch.from_numpy(images), torch.from_numpy(sizes),
            torch.from_numpy(scales),
        )
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].any()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["mask_probs"], want["mask_probs"],
                               rtol=0, atol=1e-4)


def test_decode_topk_path_matches_jax():
    """The per-class top-k route of decode (k < Rp, the full-size
    configuration's route) against the JAX package's ``_decode_single``."""
    kw = dict(n_fg_class=5, detections_per_im=10, nms_topk_per_class=16)
    jcfg = jax_mrcnn.MaskRCNNConfig(**kw)
    tcfg = mask_rcnn.MaskRCNNConfig(**kw)
    rng = np.random.RandomState(2)
    n, rp = 2, 40
    roi = np.stack([random_boxes(rng, rp, 80, 120, min_size=4)
                    for _ in range(n)])
    valid = rng.rand(n, rp) > 0.2
    cls_loc = (rng.randn(n, rp, 6 * 4) * 0.5).astype(np.float32)
    score = (rng.randn(n, rp, 6) * 2).astype(np.float32)
    sizes = np.array([[60.0, 90.0], [50.0, 100.0]], np.float32)
    scales = np.array([1.25, 1.0], np.float32)

    want = jax.vmap(
        lambda r, rv, cl, sc, sz, s: jax_mrcnn._decode_single(
            jcfg, r, rv, cl, sc, sz, s)
    )(roi, valid, cls_loc, score, sizes, scales)
    got = mask_rcnn.decode(
        tcfg, *(torch.from_numpy(a) for a in
                (roi, valid, cls_loc, score, sizes, scales))
    )
    assert np.asarray(want[3]).any()
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
