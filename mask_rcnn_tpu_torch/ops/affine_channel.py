"""Folding frozen BatchNorm statistics into the per-channel affine, the
port of ``mask_rcnn_tpu/ops/affine_channel.py::fold_batch_norm``. The
affine itself is ``models/resnet.py::affine``."""

from __future__ import annotations

import torch


def fold_batch_norm(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN statistics into (scale, bias) — reference
    ``_get_affine_from_bn`` (models/resnet_extractor.py:16-29)."""
    std = torch.sqrt(var + eps)
    scale = gamma / std
    bias = beta - mean * scale
    return {"scale": scale, "bias": bias}
