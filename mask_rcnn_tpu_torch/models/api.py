"""User-facing model API, the port of ``mask_rcnn_tpu/models/api.py``:
the reference's ``MaskRCNNResNet`` surface on top of
:func:`~mask_rcnn_tpu_torch.models.mask_rcnn.predict_step`.

Preparation (resize to ``min_size`` capped by ``max_size``, mean
subtraction, padding to the orientation bucket) runs on the model's device
without cv2; mask pasting runs on the host. CUDA work is asynchronous, so
:meth:`MaskRCNNResNet.predict_submit` returns before the device finishes and
:meth:`MaskRCNNResNet.predict_stream` keeps several batches in flight.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mask_rcnn_tpu_torch.data.loader import bucket_shape, round_up
from mask_rcnn_tpu_torch.models import rpn as rpn_mod
from mask_rcnn_tpu_torch.models.mask_rcnn import (
    MaskRCNNConfig,
    cast_params,
    init_params,
    predict_step,
)
from mask_rcnn_tpu_torch.utils.checkpoint import load_params
from mask_rcnn_tpu_torch.utils.masks import paste_masks, resize_bilinear


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without making the host wait for the
    device (pinned memory, asynchronous copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class MaskRCNNResNet:
    """Mask R-CNN R-50/101-C4 with the reference's constructor surface.

    ``predict`` takes a list of (3, H, W) float32 RGB images (0-255) and
    returns per image ``(bboxes (R, 4) y1x1y2x2, masks (R, H, W) bool,
    labels (R,) 0-based, scores (R,))``. ``pad_to_bucket`` (default True)
    pads to the static orientation buckets of ``data/loader.bucket_shape``.
    ``pretrained_model`` is an npz in the parameter bridge's layout (what
    either package's ``save_params`` writes). The model runs on the card
    unless ``device`` says otherwise (``device="cpu"`` for the plain
    versions of every kernel).
    """

    def __init__(
        self,
        n_layers: int = 50,
        n_fg_class: Optional[int] = None,
        pretrained_model: Optional[str] = None,
        min_size: int = 600,
        max_size: int = 1000,
        ratios=(0.5, 1.0, 2.0),
        anchor_scales=(4.0, 8.0, 16.0, 32.0),
        mean=(123.152, 115.903, 103.063),
        roi_size: int = 14,
        pooling_func: str = "align",
        proposal_creator_params: Optional[dict] = None,
        rng_seed: int = 0,
        compute_dtype: str = "float32",
        pad_to_bucket: bool = True,
        uint8_input: bool = False,
        device="cuda",
    ):
        if n_fg_class is None:
            raise ValueError("n_fg_class is required")
        pcp = dict(min_size=0.0, n_test_pre_nms=6000, n_test_post_nms=1000)
        if proposal_creator_params:
            pcp.update(proposal_creator_params)
        config = MaskRCNNConfig(
            n_fg_class=n_fg_class,
            n_layers=n_layers,
            min_size=min_size,
            max_size=max_size,
            ratios=tuple(ratios),
            anchor_scales=tuple(float(s) for s in anchor_scales),
            mean=tuple(mean),
            roi_size=roi_size,
            pooling=pooling_func,
            proposal=rpn_mod.ProposalConfig(**pcp),
            compute_dtype=compute_dtype,
        )
        device = torch.device(device)
        if pretrained_model:
            # The config's names, shapes and dtypes on the meta device (no
            # weights drawn): a mismatched npz raises here, as the JAX
            # constructor's conform_params does, not in a later predict.
            with torch.device("meta"):
                like = init_params(config, torch.Generator(), "meta")
            params = load_params(pretrained_model, device, like=like)
        else:
            gen = torch.Generator().manual_seed(rng_seed)
            params = init_params(config, gen, device)
        self._setup(config, params, device, pad_to_bucket, uint8_input)

    @classmethod
    def from_config(cls, config: MaskRCNNConfig, params, device=None,
                    pad_to_bucket: bool = True,
                    uint8_input: bool = False) -> "MaskRCNNResNet":
        """Wrap existing (config, params); the device defaults to the
        params' own."""
        model = cls.__new__(cls)
        if device is None:
            device = params["head"]["score"]["W"].device
        model._setup(config, params, torch.device(device), pad_to_bucket,
                     uint8_input)
        return model

    def _setup(self, config, params, device, pad_to_bucket, uint8_input):
        self.config = config
        self.params = params
        self.device = device
        self.score_thresh = 0.05
        self.pad_to_bucket = pad_to_bucket
        self.uint8_input = uint8_input
        self._cast = (None, None)  # (params object, its compute-dtype copy)

    @property
    def n_class(self):
        return self.config.n_class

    def use_preset(self, preset: str):
        """'visualize' -> score 0.7; 'evaluate' -> 0.05 (chainercv idiom)."""
        self.score_thresh = {"visualize": 0.7, "evaluate": 0.05}[preset]

    def _compute_params(self):
        """The params in the compute dtype, cast once per params object."""
        if self._cast[0] is not self.params:
            self._cast = (self.params,
                          cast_params(self.params, self.config.compute_dtype))
        return self._cast[1]

    # -- preprocessing ---------------------------------------------------
    def prepare(self, imgs: Sequence[np.ndarray]):
        """Resize so the short side is ``min_size`` capped by ``max_size``
        (``scale = min_size / min(h, w)``, then ``max_size / max(h, w)`` if
        the long side would exceed it), on the device, with cv2
        ``INTER_LINEAR`` semantics; subtract the mean.

        Returns (list of (h', w', 3) device tensors, original sizes,
        scales). With ``uint8_input`` the images go up as uint8 (4x less
        host-to-device traffic), the resize result is rounded back to uint8
        and the mean is subtracted inside the predict step.
        """
        prepared, sizes, scales = [], [], []
        cfg = self.config
        mean = None
        for img in imgs:
            if img.ndim != 3:
                raise ValueError("expected (3, H, W) images")
            _, h, w = img.shape
            scale = 1.0
            if cfg.min_size:
                scale = cfg.min_size / min(h, w)
            if cfg.max_size and scale * max(h, w) > cfg.max_size:
                scale = cfg.max_size / max(h, w)
            # cv2's dsize for fx=fy=scale: round half to even
            out_h, out_w = int(round(h * scale)), int(round(w * scale))
            chw = np.asarray(img)
            if self.uint8_input:
                chw = np.clip(chw, 0, 255).astype(np.uint8)
            else:
                chw = chw.astype(np.float32, copy=False)
            # upload (3, H, W) as given; the HWC layout is a device-side view
            x = _upload(chw, self.device).permute(1, 2, 0)
            x = resize_bilinear(x, out_h, out_w, scale, scale)
            if self.uint8_input:
                x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
            else:
                if mean is None:
                    mean = _upload(np.asarray(cfg.mean, np.float32),
                                   self.device)
                x = x - mean
            prepared.append(x)
            sizes.append((h, w))
            scales.append(scale)
        return prepared, sizes, scales

    # -- inference -------------------------------------------------------
    def predict_submit(self, imgs: Sequence[np.ndarray]):
        """Prepare, pad and launch the predict step without waiting for
        the device. Returns a handle for :meth:`predict_collect`."""
        prepared, sizes, scales = self.prepare(imgs)
        n = len(prepared)
        cfg = self.config
        if self.pad_to_bucket:
            shapes = [bucket_shape(p.shape[0], p.shape[1], cfg.min_size,
                                   cfg.max_size) for p in prepared]
            hp = max(s[0] for s in shapes)
            wp = max(s[1] for s in shapes)
        else:
            hp = round_up(max(p.shape[0] for p in prepared), 32)
            wp = round_up(max(p.shape[1] for p in prepared), 32)
        if self.uint8_input:
            # margin at the rounded mean -> ~0 after on-device subtraction
            fill = np.round(np.asarray(cfg.mean)).astype(np.uint8)
            x = torch.empty((n, hp, wp, 3), dtype=torch.uint8,
                            device=self.device)
            for c in range(3):
                x[..., c] = int(fill[c])
        else:
            x = torch.zeros((n, hp, wp, 3), dtype=torch.float32,
                            device=self.device)
        for i, p in enumerate(prepared):
            x[i, : p.shape[0], : p.shape[1]] = p
        sizes_t = _upload(np.asarray(sizes, np.float32), self.device)
        scales_t = _upload(np.asarray(scales, np.float32), self.device)

        run_cfg = cfg
        if self.score_thresh < cfg.score_thresh:
            # decode drops candidates below cfg.score_thresh before the host
            # filter sees them, so a lower threshold goes into the step
            run_cfg = dataclasses.replace(
                cfg, score_thresh=float(self.score_thresh))
        with torch.no_grad():
            out = predict_step(self._compute_params(), run_cfg, x, sizes_t,
                               scales_t)
        return out, sizes, n

    def predict_collect(
        self, handle
    ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray],
               List[np.ndarray]]:
        """Wait for a :meth:`predict_submit` handle, then apply the score
        threshold and paste the masks at full resolution on the host."""
        bboxes, probs, labels, scores, sizes = self.predict_collect_raw(
            handle)
        masks = [paste_masks(b, p, *size)
                 for b, p, size in zip(bboxes, probs, sizes)]
        return bboxes, masks, labels, scores

    def predict_collect_raw(self, handle):
        """Wait for a :meth:`predict_submit` handle without pasting masks:
        per image ``(bboxes, mask_probs (R, M, M), labels, scores)`` after
        the score threshold, and the original sizes. Evaluation scores these
        box-locally (``add_boxlocal``), skipping the full-resolution paste
        (mask_rcnn_tpu/models/api.py:358-377)."""
        out, sizes, n = handle
        out = {k: v.cpu().numpy() for k, v in out.items()}
        bboxes, probs, labels, scores = [], [], [], []
        for i in range(n):
            valid = out["valid"][i] & (out["scores"][i] >= self.score_thresh)
            bboxes.append(out["boxes"][i][valid].astype(np.float32))
            labels.append(out["labels"][i][valid].astype(np.int32))
            scores.append(out["scores"][i][valid].astype(np.float32))
            probs.append(out["mask_probs"][i][valid].astype(np.float32))
        return bboxes, probs, labels, scores, sizes[:n]

    def predict(self, imgs: Sequence[np.ndarray]):
        return self.predict_collect(self.predict_submit(imgs))

    def predict_stream(self, batches, depth: int = 2):
        """Pipelined inference over an iterable of image batches: yields
        one :meth:`predict` result per batch, in order, with up to
        ``depth`` batches launched before the oldest is collected, so host
        preparation and pasting overlap device compute."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        pending = deque()
        for imgs in batches:
            pending.append(self.predict_submit(imgs))
            if len(pending) >= depth:
                yield self.predict_collect(pending.popleft())
        while pending:
            yield self.predict_collect(pending.popleft())
