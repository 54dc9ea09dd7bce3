"""Per-channel affine transform (the frozen-BatchNorm replacement), the port
of ``mask_rcnn_tpu/ops/affine_channel.py``: ``y = scale * x + bias`` over
the last (channel) axis, its parameters' initializer, and the folding of
BatchNorm statistics into it. ``models/resnet.py::affine`` applies the
backbone's affines."""

from __future__ import annotations

import torch


def affine_channel(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """x: (..., C) NHWC; scale/bias: (C,)."""
    return x * scale + bias


def init_affine_channel(channels: int, device="cuda"):
    """Parameters: scale=1, bias=0 (reference link defaults), float32 on
    ``device`` (the card unless the caller asks otherwise)."""
    return {
        "scale": torch.ones((channels,), dtype=torch.float32, device=device),
        "bias": torch.zeros((channels,), dtype=torch.float32, device=device),
    }


def fold_batch_norm(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN statistics into (scale, bias) — reference
    ``_get_affine_from_bn`` (models/resnet_extractor.py:16-29)."""
    std = torch.sqrt(var + eps)
    scale = gamma / std
    bias = beta - mean * scale
    return {"scale": scale, "bias": bias}
