"""The port's train step against the JAX package on the CPU in float32:
``train_loss`` (metrics and every parameter's gradient), the optimizer and
``make_train_step`` across a learning-rate drop through a carried-across
``TrainState``, and the pieces the train path added to the models
(``freeze_at``/``remat``, ``mask_subset``, the ``initializer`` option).
Parameters cross through the bridge; the target creators get the
priorities ``jax.random.uniform`` draws on the JAX package's keys. One JAX
``value_and_grad`` compile is shared through a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mask_rcnn_tpu.data.synthetic import (
    make_synthetic_train_batch as jax_synthetic_batch,
)
from mask_rcnn_tpu.engine import trainer as jax_trainer
from mask_rcnn_tpu.models import heads as jax_heads
from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu.models import rpn as jax_rpn
from mask_rcnn_tpu.models import targets as jax_targets
from mask_rcnn_tpu.models.train_model import train_loss as jax_train_loss
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_train_batch
from mask_rcnn_tpu_torch.engine import trainer
from mask_rcnn_tpu_torch.models import heads, mask_rcnn, rpn, targets
from mask_rcnn_tpu_torch.models.train_model import train_loss
from mask_rcnn_tpu_torch.utils import checkpoint
from tests.oracles import random_boxes

N_ANCHOR_SAMPLE, N_ROI_SAMPLE = 32, 16


def config_kwargs():
    """The tiny configuration of tests/test_golden_train.py."""
    return dict(n_fg_class=3, n_layers=50, min_size=64, max_size=96,
                anchor_scales=(1.0, 2.0, 4.0), detections_per_im=8)


def proposal_kwargs():
    return dict(n_train_pre_nms=96, n_train_post_nms=24, n_test_pre_nms=96,
                n_test_post_nms=24)


def golden_batch():
    """The batch of tests/test_golden_train.py (2 and 3 notched gts)."""
    rng = np.random.RandomState(11)
    n, h, w, g = 2, 64, 96, 3
    images = (rng.randn(n, h, w, 3) * 20).astype(np.float32)
    bbox = np.zeros((n, g, 4), np.float32)
    label = np.zeros((n, g), np.int32)
    bbox_valid = np.zeros((n, g), bool)
    masks = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(2 + i):
            y1 = rng.uniform(2, h - 30)
            x1 = rng.uniform(2, w - 30)
            y2 = y1 + rng.uniform(12, 25)
            x2 = x1 + rng.uniform(12, 25)
            bbox[i, k] = (y1, x1, y2, x2)
            label[i, k] = rng.randint(0, 3)
            bbox_valid[i, k] = True
            yy1, xx1 = int(y1), int(x1)
            masks[i, k, yy1:int(y2), xx1:int(x2)] = 1
            masks[i, k, yy1:yy1 + 4, xx1:xx1 + 4] = 0
    return {"image": images, "bbox": bbox, "label": label,
            "bbox_valid": bbox_valid, "mask": masks,
            "scale": np.asarray([1.1, 0.93], np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def jax_priorities(key, n, n_cand, n_anchor):
    """The sampling priorities the JAX ``train_loss`` draws from ``key``:
    ``split(key)`` into the proposal and anchor keys, one key per image,
    ``split`` into positives and negatives (train_model.py:90, 138 and
    targets.py:37, 105, 294)."""
    key_p, key_a = jax.random.split(key)
    out = {}
    for name, k, size in (("proposal", key_p, n_cand),
                          ("anchor", key_a, n_anchor)):
        pos, neg = [], []
        for ki in jax.random.split(k, n):
            kpos, kneg = jax.random.split(ki)
            pos.append(np.asarray(jax.random.uniform(kpos, (size,))))
            neg.append(np.asarray(jax.random.uniform(kneg, (size,))))
        out[name] = (torch.from_numpy(np.stack(pos)),
                     torch.from_numpy(np.stack(neg)))
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_mrcnn.MaskRCNNConfig(
        proposal=jax_rpn.ProposalConfig(**proposal_kwargs()),
        **config_kwargs())
    tcfg = mask_rcnn.MaskRCNNConfig(
        proposal=rpn.ProposalConfig(**proposal_kwargs()), **config_kwargs())
    jparams = jax_mrcnn.init_params(jax.random.PRNGKey(7), jcfg)
    batch = golden_batch()
    n, h, w = batch["image"].shape[:3]
    n_cand = jcfg.proposal.n_train_post_nms + batch["bbox"].shape[1]
    n_anchor = (h // 16) * (w // 16) * jcfg.n_anchor
    jax_cfgs = dict(
        anchor_cfg=jax_targets.AnchorTargetConfig(n_sample=N_ANCHOR_SAMPLE),
        proposal_cfg=jax_targets.ProposalTargetConfig(n_sample=N_ROI_SAMPLE))
    port_cfgs = dict(
        anchor_cfg=targets.AnchorTargetConfig(n_sample=N_ANCHOR_SAMPLE),
        proposal_cfg=targets.ProposalTargetConfig(n_sample=N_ROI_SAMPLE))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, k: jax_train_loss(p, jcfg, b, k, **jax_cfgs),
        has_aux=True))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, batch=batch,
                jax_cfgs=jax_cfgs, port_cfgs=port_cfgs,
                value_and_grad=value_and_grad,
                priorities=lambda key: jax_priorities(key, n, n_cand,
                                                      n_anchor))


def port_params(jparams, requires_grad=True):
    params = checkpoint.params_from_numpy(jax_ckpt.flatten_params(jparams))
    for v in checkpoint.flatten_params(params).values():
        v.requires_grad_(requires_grad)
    return params


def port_loss(s, params, batch, key):
    return train_loss(params, s["tcfg"], to_torch(batch),
                      s["priorities"](key), **s["port_cfgs"])


def test_train_loss_metrics_and_grads_match_jax(setup):
    s = setup
    key = jax.random.PRNGKey(4)
    (_, want), jgrads = s["value_and_grad"](s["jparams"], s["batch"], key)
    params = port_params(s["jparams"])
    loss, got = port_loss(s, params, s["batch"], key)
    for k in want:
        # float32 on both sides, sums in another order: 1e-4 relative
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(want["roi_mask_loss"]) > 0 and float(want["rpn_loc_loss"]) > 0

    flat = checkpoint.flatten_params(params)
    names = sorted(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in names],
                                allow_unused=True)
    jflat = checkpoint.params_from_numpy(jax_ckpt.flatten_params(jgrads))
    jflat = checkpoint.flatten_params(jflat)
    n_frozen = 0
    for k, g in zip(names, grads):
        w = jflat[k].numpy()
        stage = k.split("/")[1]
        if k.startswith("extractor/") and stage in trainer.FROZEN_STAGES:
            # freeze_at="res2": no gradient reaches the frozen stages
            assert g is None and not w.any(), k
            n_frozen += 1
            continue
        scale = np.abs(w).max()
        assert scale > 0, k
        # float32 convs and matmuls summed in another order: 1e-3 of the
        # leaf's largest gradient
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
    assert n_frozen > 20


def test_train_loss_takes_uint8_images_and_packed_masks(setup):
    """uint8 pixels are normalized on the device exactly as a float
    mean-subtracted batch; bit-packed masks give the unpacked targets."""
    s = setup
    key = jax.random.PRNGKey(4)
    params = port_params(s["jparams"], requires_grad=False)
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, s["batch"]["image"].shape).astype(np.uint8)
    as_float = dict(s["batch"], image=(raw.astype(np.float32) - np.asarray(
        s["tcfg"].mean, np.float32)))
    as_uint8 = dict(as_float, image=raw, mask=pack_mask_bits(
        s["batch"]["mask"]))
    with torch.no_grad():
        _, want = port_loss(s, params, as_float, key)
        _, got = port_loss(s, params, as_uint8, key)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def jax_trace_flat(opt_state):
    """The momentum trace of the masked chain, frozen leaves dropped."""
    trace = opt_state[0].inner_state[-1].trace
    # MaskedNode placeholders are empty pytree nodes: they have no leaves
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(trace)}


def test_train_step_matches_jax_across_lr_drop(setup):
    """Two JAX steps at lr 0.01, carried across; the third step, after the
    drop to 0.001, in both. (A relu pre-activation within float32 rounding
    of zero would flip its gradient between the two; the fixture has none
    at this lr.)"""
    s = setup
    milestones = (2 / 3, 1.0)  # boundaries 2 and 3 of 3 steps
    tx, jsched = jax_trainer.make_optimizer(s["jparams"], 0.01, 3,
                                            milestones=milestones)
    state = jax_trainer.create_train_state(s["jparams"], tx)
    step = jax.jit(jax_trainer.make_train_step(s["jcfg"], tx,
                                               **s["jax_cfgs"]))
    rng = jax.random.PRNGKey(9)
    for _ in range(2):
        state, _ = step(state, s["batch"], rng)
    assert int(state.opt_state[0].inner_state[1].count) == 2
    params2 = {k: np.asarray(v)
               for k, v in jax_ckpt.flatten_params(state.params).items()}
    trace2 = jax_trace_flat(state.opt_state)

    tstate = checkpoint.train_state_from_numpy(params2, trace2,
                                               int(state.step))
    opt, sched = trainer.make_optimizer(tstate.params, 0.01, 3,
                                        milestones=milestones)
    assert sched(1) == float(jsched(1)) == np.float32(0.01)
    assert sched(2) == float(jsched(2)) == np.float32(np.float32(0.01) *
                                                      np.float32(0.1))
    assert opt.trainable == set(trace2)
    tstep = trainer.make_train_step(s["tcfg"], opt, **s["port_cfgs"])
    pri = s["priorities"](jax.random.fold_in(rng, 2))
    tstate, tmetrics = tstep(tstate, to_torch(s["batch"]), pri)
    state, metrics = step(state, s["batch"], rng)
    assert tstate.step == int(state.step) == 3
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)

    got_p, got_v, _ = checkpoint.train_state_to_numpy(tstate)
    want_p = {k: np.asarray(v)
              for k, v in jax_ckpt.flatten_params(state.params).items()}
    want_v = jax_trace_flat(state.opt_state)
    assert set(got_v) == set(want_v) == set(trace2)
    for k, w in want_p.items():
        if k not in want_v:  # frozen: bit-identical, untouched
            np.testing.assert_array_equal(got_p[k], params2[k], err_msg=k)
            np.testing.assert_array_equal(w, params2[k], err_msg=k)
            continue
        # the step's update differs by the gradients' 1e-3; the weight by
        # a few float32 roundings of w + v
        step_size = np.abs(w - params2[k]).max()
        ulp = np.finfo(np.float32).eps * np.abs(w).max()
        np.testing.assert_allclose(got_p[k], w, rtol=0,
                                   atol=1e-3 * step_size + 4 * ulp,
                                   err_msg=k)
        np.testing.assert_allclose(got_v[k], want_v[k], rtol=0,
                                   atol=1e-3 * np.abs(want_v[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_optimizer_matches_optax_across_lr_drop(clip_norm):
    """The hand-written update against the JAX package's optax chain on
    synthetic gradients: same order of float32 ops, so within an ulp or
    two; frozen leaves bit-identical."""
    rng = np.random.RandomState(12)
    flat = {
        "extractor/conv1/W": rng.randn(4, 3, 3, 2),
        "extractor/res3/a/conv1/W": rng.randn(1, 1, 4, 5),
        "extractor/res3/a/bn1/scale": rng.randn(5),
        "head/score/W": rng.randn(6, 3),
        "head/score/b": rng.randn(3),
    }
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    jparams = jax_ckpt.unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()})
    tx, _ = jax_trainer.make_optimizer(jparams, 0.1, 4, milestones=(0.5,),
                                       clip_norm=clip_norm)
    opt_state = tx.init(jparams)
    params = checkpoint.params_from_numpy(flat)
    opt, _ = trainer.make_optimizer(params, 0.1, 4, milestones=(0.5,),
                                    clip_norm=clip_norm)
    tstate = trainer.create_train_state(params, opt)
    for step in range(4):
        gflat = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
                 for k, v in flat.items()}
        updates, opt_state = tx.update(
            jax_ckpt.unflatten_params(
                {k: jnp.asarray(v) for k, v in gflat.items()}),
            opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = checkpoint.flatten_params(checkpoint.params_from_numpy(gflat))
        opt.apply(tstate.params, tstate.momentum, grads, step)
    got = checkpoint.params_to_numpy(tstate.params)
    for k, w in jax_ckpt.flatten_params(jparams).items():
        w = np.asarray(w)
        if trainer.is_trainable(k):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
            np.testing.assert_array_equal(w, flat[k], err_msg=k)
    got_v = checkpoint.params_to_numpy(tstate.momentum)
    for k, v in jax_trace_flat(opt_state).items():
        np.testing.assert_allclose(got_v[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_train_state_bridge_round_trip():
    rng = np.random.RandomState(13)
    params = {"extractor/res3/a/conv1/W": rng.randn(1, 1, 4, 5),
              "extractor/res3/a/bn1/scale": rng.randn(5),
              "head/deconv6/W": rng.randn(2, 2, 6, 3),
              "head/score/W": rng.randn(6, 3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    momentum = {k: v * 0.5 for k, v in params.items()
                if trainer.is_trainable(k)}
    state = checkpoint.train_state_from_numpy(params, momentum, 7)
    assert state.step == 7
    assert tuple(state.params["extractor"]["res3"]["a"]["conv1"]["W"]
                 .shape) == (5, 4, 1, 1)  # OIHW
    assert tuple(state.momentum["head"]["deconv6"]["W"].shape) == (6, 3, 2,
                                                                   2)
    assert not state.params["extractor"]["res3"]["a"]["bn1"]["scale"] \
        .requires_grad
    assert state.params["head"]["score"]["W"].requires_grad
    p, m, step = checkpoint.train_state_to_numpy(state)
    assert step == 7 and set(p) == set(params) and set(m) == set(momentum)
    for k in params:
        np.testing.assert_array_equal(p[k], params[k])
    for k in momentum:
        np.testing.assert_array_equal(m[k], momentum[k])


def test_is_trainable_matches_jax(setup):
    jparams = setup["jparams"]
    want = jax_ckpt.flatten_params(jax_trainer.trainable_mask(jparams))
    got = checkpoint.flatten_params(trainer.trainable_mask(
        port_params(jparams, requires_grad=False)))
    assert got == {k: bool(v) for k, v in want.items()}


def test_backbone_freeze_and_remat_match_jax(setup):
    """``forward_backbone_rpn(train=True)`` with ``remat`` against JAX;
    remat changes no gradient, and freeze_at cuts it after res2."""
    s = setup
    jcfg = jax_mrcnn.MaskRCNNConfig(remat=True, **config_kwargs())
    tcfg = mask_rcnn.MaskRCNNConfig(remat=True, **config_kwargs())
    images = s["batch"]["image"]
    want = jax_mrcnn.forward_backbone_rpn(s["jparams"], jcfg,
                                          jnp.asarray(images), train=True)
    grads = {}
    for cfg in (tcfg, mask_rcnn.MaskRCNNConfig(**config_kwargs())):
        params = port_params(s["jparams"])
        got = mask_rcnn.forward_backbone_rpn(params, cfg,
                                             torch.from_numpy(images),
                                             train=True)
        for g, w, name in zip(got, want, ("feats", "locs", "scores")):
            w = np.asarray(w)
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        (got[1].sum() + got[2].square().sum()).backward()
        ex = params["extractor"]
        assert ex["conv1"]["W"].grad is None
        assert ex["res2"]["a"]["conv1"]["W"].grad is None
        grads[cfg.remat] = ex["res3"]["a"]["conv1"]["W"].grad
    torch.testing.assert_close(grads[True], grads[False], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("initializer", ["normal", "he_normal"])
def test_init_head_initializer_matches_jax(initializer):
    want = jax_ckpt.flatten_params(jax_heads.init_head(
        jax.random.PRNGKey(0), 81, initializer=initializer))
    got = checkpoint.params_to_numpy(heads.init_head(
        torch.Generator().manual_seed(0), 81, initializer=initializer))
    assert set(got) == set(want)
    for k in ("deconv6/W", "mask/W"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        # same distribution, not the same bits
        np.testing.assert_allclose(got[k].std(), w.std(), rtol=0.1)
    with pytest.raises(ValueError):
        heads.init_head(torch.Generator(), 81, initializer="xavier")
    cfg = mask_rcnn.MaskRCNNConfig(n_fg_class=80)
    p = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(0),
                              initializer=initializer)
    np.testing.assert_allclose(p["head"]["mask"]["W"].std().item(),
                               np.asarray(want["mask/W"]).std(), rtol=0.1)


def test_head_mask_subset_matches_jax(setup):
    s = setup
    rng = np.random.RandomState(14)
    feats = rng.randn(2, 4, 6, 1024).astype(np.float32)
    rois = np.stack([random_boxes(rng, 5, 64, 96, min_size=4)
                     for _ in range(2)])
    subset = np.array([0, 1, 5, 6], np.int32)
    want = jax_heads.head_forward(
        s["jparams"]["head"], jnp.asarray(feats), jnp.asarray(rois), None,
        roi_size=14, spatial_scale=1 / 16, mask_subset=jnp.asarray(subset))
    params = port_params(s["jparams"], requires_grad=False)
    with torch.no_grad():
        got = heads.head_forward(params["head"], torch.from_numpy(feats),
                                 torch.from_numpy(rois), roi_size=14,
                                 spatial_scale=1 / 16,
                                 mask_subset=torch.from_numpy(subset).long())
        full = heads.head_forward(params["head"], torch.from_numpy(feats),
                                  torch.from_numpy(rois), roi_size=14,
                                  spatial_scale=1 / 16)
    assert got["masks"].shape[0] == len(subset)
    assert torch.equal(got["masks"], full["masks"][subset])
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_synthetic_train_batch_matches_jax():
    got = make_synthetic_train_batch(2, 256, 320, np.random.RandomState(3))
    want = jax_synthetic_batch(2, 256, 320, np.random.RandomState(3))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["mask"].shape == (2, 8, 256, 40)
    with pytest.raises(ValueError):
        pack_mask_bits(np.zeros((3, 10), np.uint8))
