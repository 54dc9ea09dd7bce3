"""Synthetic pretrained-weight files for the importers, shared by the CPU
parity tests (``tests/test_torch_importers.py``, ``test_torch_drivers.py``)
and ``chip_smoke.py``. Imports numpy only (no jax, no torch), so the smoke
can use it on a machine without jax.

Blob and array names follow the reference formats: a Detectron
e2e_mask_rcnn_R-{50,101}-C4 caffe2 pkl (``{"blobs": {...}}``, OIHW convs,
loc outputs in (x, y, w, h) order, a background mask channel) and a chainer
``ResNet{50,101}Layers`` ImageNet npz (``conv1/W``, ``bn1/{gamma, beta,
avg_mean, avg_var}``, ``res2/a/conv1/W``, ..., ``fc6``). Weights are drawn
from a seed at the scales of the port's initializer (``models/resnet.py``:
He-normal convs; a folded affine near 0.5 on the stem, 1 inside a block
and 0.1 on a block's residual and projection outputs; heads near std
0.01), so a model built from them keeps finite activations at full width
and trains at the drivers' learning rate.
"""

from __future__ import annotations

import pickle

import numpy as np

RESNET_N_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
# the folded affine's scale on the stem, inside a block, on its outputs
STEM_SCALE, INNER_SCALE, OUTPUT_SCALE = 0.5, 1.0, 0.1
# (in, mid, out) channels of res2..res5
STAGE_CHANNELS = ((64, 64, 256), (256, 128, 512), (512, 256, 1024),
                  (1024, 512, 2048))


def fake_detectron_blobs(n_fg=3, n_anchor=2, n_layers=50, seed=0):
    """A caffe2 blob dict with the R-{50,101}-C4 Mask R-CNN schema."""
    rng = np.random.RandomState(seed)
    blobs = {}

    def conv(name, o, i, k, std=None):
        std = np.sqrt(2.0 / (i * k * k)) if std is None else std
        blobs[name + "_w"] = (rng.randn(o, i, k, k) * std).astype(np.float32)

    def bn(name, c, scale=INNER_SCALE):
        blobs[name + "_bn_s"] = (scale * rng.uniform(0.9, 1.1, c)).astype(
            np.float32)
        blobs[name + "_bn_b"] = (rng.randn(c) * 0.01).astype(np.float32)

    conv("conv1", 64, 3, 7)
    blobs["conv1_b"] = (rng.randn(64) * 0.01).astype(np.float32)
    bn("res_conv1", 64, STEM_SCALE)
    for s, nb in zip((2, 3, 4, 5), RESNET_N_BLOCKS[n_layers]):
        cin, mid, cout = STAGE_CHANNELS[s - 2]
        for b in range(nb):
            pre = f"res{s}_{b}"
            icin = cin if b == 0 else cout
            conv(pre + "_branch2a", mid, icin, 1)
            bn(pre + "_branch2a", mid)
            conv(pre + "_branch2b", mid, mid, 3)
            bn(pre + "_branch2b", mid)
            conv(pre + "_branch2c", cout, mid, 1)
            bn(pre + "_branch2c", cout, OUTPUT_SCALE)
            if b == 0:
                conv(pre + "_branch1", cout, icin, 1)
                bn(pre + "_branch1", cout, OUTPUT_SCALE)

    def bias(name, n, std=0.01):
        blobs[name + "_b"] = (rng.randn(n) * std).astype(np.float32)

    n_class = n_fg + 1
    conv("conv_rpn", 1024, 1024, 3, std=0.01)
    bias("conv_rpn", 1024)
    conv("rpn_cls_logits", n_anchor, 1024, 1, std=0.01)
    bias("rpn_cls_logits", n_anchor)
    conv("rpn_bbox_pred", n_anchor * 4, 1024, 1, std=0.01)
    bias("rpn_bbox_pred", n_anchor * 4)
    blobs["bbox_pred_w"] = (rng.randn(n_class * 4, 2048) * 0.001).astype(
        np.float32)
    bias("bbox_pred", n_class * 4, 0.001)
    blobs["cls_score_w"] = (rng.randn(n_class, 2048) * 0.01).astype(
        np.float32)
    bias("cls_score", n_class)
    conv("conv5_mask", 2048, 256, 2, std=0.01)
    bias("conv5_mask", 256)
    conv("mask_fcn_logits", n_class, 256, 1, std=0.01)
    bias("mask_fcn_logits", n_class)
    return blobs


def write_detectron_pkl(path, **kw):
    """Write :func:`fake_detectron_blobs` as a Detectron pkl; returns the
    blobs."""
    blobs = fake_detectron_blobs(**kw)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return blobs


def write_imagenet_npz(path, n_layers=50, with_conv1_b=True, seed=42):
    """Write a chainer ``ResNet{50,101}Layers`` classification npz; returns
    its arrays."""
    rng = np.random.RandomState(seed)
    flat = {}

    def conv(key, o, i, k):
        flat[key + "/W"] = (rng.randn(o, i, k, k)
                            * np.sqrt(2.0 / (i * k * k))).astype(np.float32)

    def bn(key, c, scale=INNER_SCALE):
        # statistics whose fold gives ~scale and a bias near 0
        var = (rng.rand(c) + 0.5).astype(np.float32)
        flat[key + "/gamma"] = (scale * np.sqrt(var + 1e-5)
                                * rng.uniform(0.9, 1.1, c)).astype(np.float32)
        flat[key + "/beta"] = (rng.randn(c) * 0.01).astype(np.float32)
        flat[key + "/avg_mean"] = (rng.randn(c) * 0.01).astype(np.float32)
        flat[key + "/avg_var"] = var

    conv("conv1", 64, 3, 7)
    if with_conv1_b:
        flat["conv1/b"] = (rng.randn(64) * 0.01).astype(np.float32)
    bn("bn1", 64, STEM_SCALE)
    for si, nb in enumerate(RESNET_N_BLOCKS[n_layers]):
        stage = f"res{si + 2}"
        cin, mid, cout = STAGE_CHANNELS[si]
        names = ["a"] + [f"b{i}" for i in range(1, nb)]
        for bi, nm in enumerate(names):
            pre = f"{stage}/{nm}"
            icin = cin if bi == 0 else cout
            conv(pre + "/conv1", mid, icin, 1)
            bn(pre + "/bn1", mid)
            conv(pre + "/conv2", mid, mid, 3)
            bn(pre + "/bn2", mid)
            conv(pre + "/conv3", cout, mid, 1)
            bn(pre + "/bn3", cout, OUTPUT_SCALE)
            if bi == 0:
                conv(pre + "/conv4", cout, icin, 1)
                bn(pre + "/bn4", cout, OUTPUT_SCALE)
    flat["fc6/W"] = (rng.randn(1000, 2048) * 0.01).astype(np.float32)
    flat["fc6/b"] = np.zeros(1000, np.float32)
    np.savez(path, **flat)
    return flat
