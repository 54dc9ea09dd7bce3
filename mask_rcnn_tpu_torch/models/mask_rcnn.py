"""Mask R-CNN (R-50/101-C4): config, parameter init, the backbone + RPN
forward and the predict step, the port of
``mask_rcnn_tpu/models/mask_rcnn.py`` (the train loss is in
``train_model.py``).

Everything from pixels to per-class-NMS'd detections and mask
probabilities runs on the tensors' device with static shapes and no host
synchronisation on the GPU path; the JAX package's ``vmap``s over images
and classes are batch dimensions written out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from mask_rcnn_tpu_torch.models import heads, resnet, rpn
from mask_rcnn_tpu_torch.ops import anchors as anchor_ops
from mask_rcnn_tpu_torch.ops.boxes import loc2bbox
from mask_rcnn_tpu_torch.ops.nms import nms_padded
from mask_rcnn_tpu_torch.ops.roi_align import POOLING_FUNCS
from mask_rcnn_tpu_torch.models.rpn import top_k_stable


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    """Static model/inference configuration (the JAX package's defaults).

    ``pooling`` picks the head's RoI pooler (``ops.roi_align.POOLING_FUNCS``,
    the reference's ``--pooling-func``): ``"align"`` RoIAlign (kernels
    K1/K7), ``"resize"`` crop-and-resize (K5/K11) or ``"pooling"``
    quantized max RoI pooling (K6/K12).
    """

    n_fg_class: int
    n_layers: int = 50
    min_size: int = 600
    max_size: int = 1000
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scales: Tuple[float, ...] = (4.0, 8.0, 16.0, 32.0)
    mean: Tuple[float, float, float] = (123.152, 115.903, 103.063)
    feat_stride: int = 16
    rpn_hidden: int = 1024
    roi_size: int = 14
    mask_size: int = 14
    pooling: str = "align"
    sampling_ratio: int = 0
    proposal: rpn.ProposalConfig = rpn.ProposalConfig()
    loc_normalize_mean: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    loc_normalize_std: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    nms_thresh: float = 0.5
    score_thresh: float = 0.05
    detections_per_im: int = 100
    compute_dtype: str = "float32"
    # Per-class candidate cap before decode NMS: exact unless more than K
    # boxes of one class clear score_thresh (0 disables it).
    nms_topk_per_class: int = 256
    # Recompute the backbone stages' activations in the backward pass
    # (less activation memory for ~1/3 more backbone FLOPs).
    remat: bool = False

    def __post_init__(self):
        if self.pooling not in POOLING_FUNCS:
            raise ValueError(
                f"pooling={self.pooling!r}: expected one of "
                f"{sorted(POOLING_FUNCS)}"
            )

    @property
    def n_class(self) -> int:
        return self.n_fg_class + 1

    @property
    def n_anchor(self) -> int:
        return len(self.ratios) * len(self.anchor_scales)


def init_params(cfg: MaskRCNNConfig, generator: torch.Generator,
                device="cpu", initializer="normal"):
    """Seeded parameters with the JAX package's distributions (he_normal
    convs, bn1 scale 0.5, residual affine scale 0.1, RPN std 0.01, cls_loc
    std 0.001), drawn on the CPU from ``generator`` and moved to
    ``device``. ``initializer`` selects the mask branch's init ('normal' or
    'he_normal'), like the reference's ``--initializer`` flag."""
    params = {
        "extractor": resnet.init_extractor(generator, cfg.n_layers),
        "rpn": rpn.init_rpn(generator, 1024, cfg.rpn_hidden, cfg.n_anchor),
        "head": heads.init_head(generator, cfg.n_class, cfg.n_layers,
                                initializer=initializer),
    }
    return map_params(lambda t: t.to(device), params)


def map_params(fn, params):
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def make_anchors(cfg: MaskRCNNConfig, feat_h: int, feat_w: int) -> np.ndarray:
    base = anchor_ops.generate_anchor_base(
        base_size=16.0, ratios=cfg.ratios, anchor_scales=cfg.anchor_scales
    )
    return anchor_ops.enumerate_shifted_anchors(
        base, cfg.feat_stride, feat_h, feat_w
    )


@functools.lru_cache(maxsize=32)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small float32 tensor on ``device``, uploaded once: an upload on
    every step would make the host wait for the device mid-step. Callers
    must not modify it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _anchors(cfg: MaskRCNNConfig, feat_h: int, feat_w: int,
             device: torch.device) -> torch.Tensor:
    """Anchors on ``device``, uploaded once per feature shape."""
    return torch.from_numpy(make_anchors(cfg, feat_h, feat_w)).to(device)


def cast_params(params, dtype):
    """Cast every float param, affines included, to the compute dtype."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype in (None, torch.float32):
        return params
    return map_params(
        lambda t: t.to(dtype) if t.is_floating_point() else t, params
    )


def set_float32_precision():
    """Full float32 for float32 convs and matmuls (no TF32 on either), so a
    float32 run computes what the float32 JAX reference computes. The
    bfloat16 path is unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def forward_backbone_rpn(params, cfg, images, train=False):
    """images (N, H, W, 3), mean-subtracted and padded -> (features,
    rpn_locs, rpn_scores, anchors). ``train`` freezes the stages up to res2
    and rematerializes when ``cfg.remat``."""
    x = images.to(getattr(torch, cfg.compute_dtype))
    feats = resnet.extractor_forward(params["extractor"], x, cfg.n_layers,
                                     train=train, remat=cfg.remat)
    locs, scores = rpn.rpn_forward(params["rpn"], feats)
    anchors = _anchors(cfg, feats.shape[1], feats.shape[2], feats.device)
    return feats, locs, scores, anchors


def _gather_rows(x, idx):
    """x (..., R, K), idx (..., D) -> (..., D, K)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def decode(cfg, roi, roi_valid, cls_loc, score, sizes, scales):
    """Batched detection decode: de-normalize locs, per-class NMS (kernel
    K3 over images x classes), zero-area drop, top ``detections_per_im``
    (the JAX package's ``_decode_single`` over a batch).

    Args: roi (N, Rp, 4), roi_valid (N, Rp), cls_loc (N, Rp, n_class*4),
    score (N, Rp, n_class), sizes (N, 2), scales (N,).

    Returns (boxes (N, D, 4) original-image coords, labels (N, D) 0-based,
    -1 pad, scores (N, D), valid (N, D)).
    """
    n, rp = roi.shape[:2]
    n_class, n_fg, d = cfg.n_class, cfg.n_fg_class, cfg.detections_per_im
    dev = roi.device

    prob = torch.softmax(score.float(), dim=-1)  # (N, Rp, n_class)
    mean = _constant(tuple(cfg.loc_normalize_mean) * n_class, dev)
    std = _constant(tuple(cfg.loc_normalize_std) * n_class, dev)
    cls_loc = (cls_loc.float() * std + mean).reshape(n, rp, n_class, 4)
    roi_img = roi / scales[:, None, None]
    cls_bbox = loc2bbox(roi_img[:, :, None, :].expand_as(cls_loc), cls_loc)
    # clip to the original image extent
    hi = sizes[:, None, None, :].repeat(1, 1, 1, 2)  # (N, 1, 1, 4): h w h w
    cls_bbox = torch.minimum(torch.clamp(cls_bbox, min=0.0), hi)

    # classes 1..n_class-1, one problem per (image, class)
    fg_boxes = cls_bbox[:, :, 1:].transpose(1, 2).reshape(n * n_fg, rp, 4)
    fg_probs = prob[:, :, 1:].transpose(1, 2).reshape(n * n_fg, rp)
    valid_l = (roi_valid[:, None, :].expand(n, n_fg, rp).reshape(n * n_fg, rp)
               & (fg_probs > cfg.score_thresh))
    k = cfg.nms_topk_per_class
    if k and k < rp:
        top_p, top_i = top_k_stable(
            torch.where(valid_l, fg_probs, -torch.inf), k
        )
        top_b = _gather_rows(fg_boxes, top_i)
        idx, mask = nms_padded(top_b, top_p, cfg.nms_thresh, d,
                               valid=torch.isfinite(top_p), presorted=True)
        sel = idx.clamp(min=0).long()
        b = _gather_rows(top_b, sel)
        s = torch.where(mask, torch.gather(top_p, 1, sel), 0.0)
    else:
        idx, mask = nms_padded(fg_boxes, fg_probs, cfg.nms_thresh, d,
                               valid=valid_l)
        sel = idx.clamp(min=0).long()
        b = _gather_rows(fg_boxes, sel)
        s = torch.gather(fg_probs, 1, sel)

    b = b.reshape(n, n_fg * d, 4)
    s = s.reshape(n, n_fg * d)
    m = mask.reshape(n, n_fg * d)
    labels = torch.arange(n_fg, dtype=torch.int32, device=dev)
    labels = labels[:, None].expand(n_fg, d).reshape(-1)

    # Drop boxes whose rounded (half to even) integer area is zero.
    bi = torch.round(b)
    area = (bi[..., 2] - bi[..., 0]) * (bi[..., 3] - bi[..., 1])
    m = m & (area > 0)

    top_s, top_i = top_k_stable(torch.where(m, s, -torch.inf), d)
    out_valid = torch.isfinite(top_s)
    out_boxes = torch.where(out_valid[..., None], _gather_rows(b, top_i), 0.0)
    out_labels = torch.where(out_valid, labels[top_i], -1)
    out_scores = torch.where(out_valid, top_s, 0.0)
    return out_boxes, out_labels, out_scores, out_valid


def predict_step(params, cfg: MaskRCNNConfig, images, sizes,
                 scales) -> Dict[str, torch.Tensor]:
    """Full inference on a padded batch.

    Args:
        images: (N, H, W, 3) float32 mean-subtracted zero-padded, or uint8
            raw pixels (mean-padded), normalized here on the device.
        sizes: (N, 2) float32 original (pre-resize) image sizes.
        scales: (N,) float32 preprocessing scale factors.

    Returns dict of padded detections: boxes (N, D, 4) in original image
    coords; labels (N, D) 0-based fg (-1 pad); scores (N, D); valid (N, D);
    mask_probs (N, D, M, M) sigmoid probabilities of the detected class.
    """
    set_float32_precision()
    n = images.shape[0]
    d = cfg.detections_per_im
    if images.dtype == torch.uint8:
        images = images.float() - _constant(tuple(cfg.mean), images.device)
    params = cast_params(params, cfg.compute_dtype)
    feats, locs, scores, anchors = forward_backbone_rpn(params, cfg, images)
    rois, rois_valid = rpn.propose_batch(
        locs, scores, anchors, images.shape[1:3], scales, cfg.proposal
    )

    rp = rois.shape[1]
    spatial_scale = 1.0 / cfg.feat_stride
    head_out = heads.head_forward(
        params["head"], feats, rois, roi_size=cfg.roi_size,
        spatial_scale=spatial_scale, pred_bbox=True, pred_mask=False,
        pooling=cfg.pooling, sampling_ratio=cfg.sampling_ratio,
    )
    boxes, labels, det_scores, valid = decode(
        cfg, rois, rois_valid, head_out["cls_locs"].reshape(n, rp, -1),
        head_out["scores"].reshape(n, rp, -1), sizes, scales,
    )

    # Second head pass on the detected boxes for the masks.
    mask_rois = (boxes * scales[:, None, None]).contiguous()
    masks = heads.head_forward(
        params["head"], feats, mask_rois, roi_size=cfg.roi_size,
        spatial_scale=spatial_scale, pred_bbox=False, pred_mask=True,
        pooling=cfg.pooling, sampling_ratio=cfg.sampling_ratio,
    )["masks"].reshape(n, d, cfg.mask_size, cfg.mask_size, cfg.n_fg_class)
    sel = labels.clamp(min=0).long()
    mask_logits = torch.gather(
        masks, -1,
        sel[:, :, None, None, None].expand(n, d, cfg.mask_size,
                                           cfg.mask_size, 1),
    )[..., 0]
    return {
        "boxes": boxes,
        "labels": labels,
        "scores": det_scores,
        "valid": valid,
        "mask_probs": torch.sigmoid(mask_logits.float()),
    }
