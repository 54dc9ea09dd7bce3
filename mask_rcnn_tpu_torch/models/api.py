"""User-facing model API, the port of ``mask_rcnn_tpu/models/api.py``:
the reference's ``MaskRCNNResNet`` surface on top of
:func:`~mask_rcnn_tpu_torch.models.mask_rcnn.predict_step`.

Preparation (resize to ``min_size`` capped by ``max_size``, mean
subtraction, padding to the orientation bucket) runs on the model's device
without cv2; mask pasting runs on the host. CUDA work is asynchronous, so
:meth:`MaskRCNNResNet.predict_submit` returns before the device finishes and
:meth:`MaskRCNNResNet.predict_stream` keeps several batches in flight. On a
CUDA device each batch's outputs come back on their own: the submit queues
their copies into pinned host memory behind the step and records an event
after them, and the collect waits for that event alone, so the batches
submitted after it stay queued on the device while the host thresholds,
pastes and prepares the next batch.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
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
from mask_rcnn_tpu_torch.parallel.mesh import (
    make_parallel_predict_step,
    replicate_params,
)
from mask_rcnn_tpu_torch.utils import profiling
from mask_rcnn_tpu_torch.utils.checkpoint import (
    conform_params,
    flatten_params,
    load_params,
    params_from_numpy,
    params_to_numpy,
    unflatten_params,
)
from mask_rcnn_tpu_torch.utils.detectron_import import (
    IMAGENET_NPZ_SOURCES,
    import_chainer_npz,
    import_detectron_pkl,
    import_imagenet_npz,
    is_chainer_snapshot,
)
from mask_rcnn_tpu_torch.utils.masks import paste_masks, resize_bilinear


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without making the host wait for the
    device (pinned memory, asynchronous copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class PredictHandle(tuple):
    """What :meth:`MaskRCNNResNet.predict_submit` returns. It unpacks as
    ``(out, sizes, n)``: the step's outputs on the device, the original
    (H, W) of each image and the number of images. On a CUDA device it
    also carries ``host``, pinned host copies of ``out`` queued on the
    device's stream behind the step, and ``ready``, the CUDA event
    recorded after those copies; on the CPU both are None."""

    def __new__(cls, out, sizes, n, host=None, ready=None):
        handle = super().__new__(cls, (out, sizes, n))
        handle.host = host
        handle.ready = ready
        return handle


def _copy_back(out, device: torch.device):
    """Queue pinned host copies of the CUDA tensors ``out`` on
    ``device``'s current stream, behind the work that computes them, and
    record an event after the copies -> (copies, event). Nothing waits for
    the device. The copies come from the caching host allocator, which
    hands a block out again only once the copy that used it has run."""
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in out.items()}
    for k, v in out.items():
        host[k].copy_(v, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return host, ready


def find_imagenet_npz(n_layers: int) -> str:
    """Locate the chainer ImageNet ResNet npz the reference auto-downloads
    (resnet_extractor.py:104-107). Search order: $MASK_RCNN_TPU_IMAGENET_NPZ,
    the chainer dataset cache, ~/data/models. Nothing is fetched: a miss
    raises ``FileNotFoundError`` naming the source."""
    url, md5, fname = IMAGENET_NPZ_SOURCES[n_layers]
    env = os.environ.get("MASK_RCNN_TPU_IMAGENET_NPZ")
    candidates = [env] if env else []
    candidates += [
        osp.expanduser(f"~/.chainer/dataset/pfnet/chainer/models/{fname}"),
        osp.expanduser(f"~/data/models/{fname}"),
    ]
    for c in candidates:
        if c and osp.exists(c):
            return c
    raise FileNotFoundError(
        f"ImageNet ResNet-{n_layers} weights not found (searched "
        f"{candidates}). Fetch {url} (md5 {md5}) and place it at one of "
        "those paths or set MASK_RCNN_TPU_IMAGENET_NPZ."
    )


def is_imagenet_spec(spec: str) -> bool:
    """Whether ``spec`` names ImageNet backbone weights ('auto',
    'auto:<npz>', 'imagenet:<npz>'): those keep the initializer's values
    for the RPN and the box and mask branches."""
    return spec == "auto" or spec.startswith(("auto:", "imagenet:"))


def resolve_pretrained_params(spec: str, like, config: MaskRCNNConfig,
                              device):
    """The reference ``pretrained_model`` surface, the JAX package's
    ``resolve_pretrained_params``: 'auto' (ImageNet backbone,
    mask_rcnn_resnet.py:69-72), 'auto:<npz>' / 'imagenet:<npz>' (explicit
    ImageNet npz), '<model>.pkl' (Detectron blobs), 'chainer:<npz>' (a
    reference ``snapshot_model.npz``, also recognised by its layout), or
    an npz in the parameter bridge's layout.

    ``like`` gives the names, shapes and dtypes the tree must have; for the
    ImageNet specs it must hold the initializer's values (the RPN and the
    box and mask branches are copied from it), for the others it may live
    on the meta device. The importers build the JAX package's layout,
    which the bridge turns into the port's tensors on ``device``."""
    if is_imagenet_spec(spec):
        if any(t.is_meta for t in flatten_params(like).values()):
            raise ValueError(
                f"pretrained_model={spec!r} keeps the initializer's RPN and "
                "branch values: pass an initialized tree, not a meta one")
        path = (spec.split(":", 1)[1] if ":" in spec
                else find_imagenet_npz(config.n_layers))
        tree = import_imagenet_npz(
            path, unflatten_params(params_to_numpy(like)), config.n_layers)
    elif spec.endswith(".pkl"):
        tree = import_detectron_pkl(spec, n_fg_class=config.n_fg_class,
                                    n_layers=config.n_layers)
    else:
        explicit_chainer = spec.startswith("chainer:")
        path = spec.split(":", 1)[1] if explicit_chainer else spec
        if not (explicit_chainer or is_chainer_snapshot(path)):
            return load_params(path, device, like=like)
        tree = import_chainer_npz(path, config.n_layers)
    return conform_params(params_from_numpy(flatten_params(tree), device),
                          like, torch.device(device))


class MaskRCNNResNet:
    """Mask R-CNN R-50/101-C4 with the reference's constructor surface.

    ``predict`` takes a list of (3, H, W) float32 RGB images (0-255) and
    returns per image ``(bboxes (R, 4) y1x1y2x2, masks (R, H, W) bool,
    labels (R,) 0-based, scores (R,))``. ``pad_to_bucket`` (default True)
    pads to the static orientation buckets of ``data/loader.bucket_shape``.
    ``pretrained_model`` takes the specs of
    :func:`resolve_pretrained_params`. The model runs on the card
    unless ``device`` says otherwise (``device="cpu"`` for the plain
    versions of every kernel). ``devices`` (the JAX ``mesh=``) shards each
    batch over several devices of this process: the params are copied to
    each, the batch is padded to a multiple of ``len(devices)`` and split
    in order, and no collective runs; the model then lives on
    ``devices[0]``.
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
        devices: Optional[Sequence] = None,
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
        device = torch.device(devices[0] if devices else device)
        if pretrained_model and not is_imagenet_spec(pretrained_model):
            # The config's names, shapes and dtypes on the meta device (no
            # weights drawn): a mismatched file raises here, as the JAX
            # constructor's conform_params does, not in a later predict.
            with torch.device("meta"):
                like = init_params(config, torch.Generator(), "meta")
            params = resolve_pretrained_params(pretrained_model, like,
                                               config, device)
        else:
            gen = torch.Generator().manual_seed(rng_seed)
            params = init_params(config, gen, device)
            if pretrained_model:
                params = resolve_pretrained_params(pretrained_model, params,
                                                   config, device)
        self._setup(config, params, device, pad_to_bucket, uint8_input,
                    devices)

    @classmethod
    def from_config(cls, config: MaskRCNNConfig, params, device=None,
                    pad_to_bucket: bool = True,
                    uint8_input: bool = False,
                    devices: Optional[Sequence] = None) -> "MaskRCNNResNet":
        """Wrap existing (config, params); the device defaults to the
        params' own (``devices[0]`` with ``devices``)."""
        model = cls.__new__(cls)
        if devices:
            device = devices[0]
        elif device is None:
            device = params["head"]["score"]["W"].device
        model._setup(config, params, torch.device(device), pad_to_bucket,
                     uint8_input, devices)
        return model

    def _setup(self, config, params, device, pad_to_bucket, uint8_input,
               devices=None):
        self.config = config
        self.params = params
        self.device = device
        self.devices = (tuple(torch.device(d) for d in devices)
                        if devices else None)
        self.score_thresh = 0.05
        self.pad_to_bucket = pad_to_bucket
        self.uint8_input = uint8_input
        self._cast = (None, None)  # (params object, its compute-dtype copy)
        self._replicas = (None, None)  # (that copy, one copy a device)
        self._newest = None  # ``ready`` event of the newest CUDA submit

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

    def _replica_params(self):
        """The compute-dtype params on each of ``devices``, copied once
        per params object."""
        cast = self._compute_params()
        if self._replicas[0] is not cast:
            self._replicas = (cast, replicate_params(cast, self.devices))
        return self._replicas[1]

    # -- preprocessing ---------------------------------------------------
    def _resize_plan(self, imgs: Sequence[np.ndarray]):
        """(scale, out_h, out_w) of each (3, H, W) image: the short side to
        ``min_size``, capped so that the long side stays within
        ``max_size``, cv2's rounding of ``dsize``."""
        cfg = self.config
        plan = []
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
            plan.append((scale, int(round(h * scale)), int(round(w * scale))))
        return plan

    def _padded_hw(self, plan):
        """(H, W) of the batch that holds the resized images of ``plan``:
        the largest orientation bucket, or the sides rounded up to 32."""
        cfg = self.config
        if self.pad_to_bucket:
            shapes = [bucket_shape(h, w, cfg.min_size, cfg.max_size)
                      for _, h, w in plan]
            return max(s[0] for s in shapes), max(s[1] for s in shapes)
        return (round_up(max(h for _, h, _ in plan), 32),
                round_up(max(w for _, _, w in plan), 32))

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
        return self._prepare(imgs, self._resize_plan(imgs))

    def _prepare(self, imgs, plan):
        prepared, sizes, scales = [], [], []
        mean = None
        for img, (scale, out_h, out_w) in zip(imgs, plan):
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
                    mean = _upload(np.asarray(self.config.mean, np.float32),
                                   self.device)
                x = x - mean
            prepared.append(x)
            sizes.append(tuple(img.shape[1:]))
            scales.append(scale)
        return prepared, sizes, scales

    # -- inference -------------------------------------------------------
    def predict_submit(self, imgs: Sequence[np.ndarray]):
        """Prepare, pad and launch the predict step without waiting for
        the device. Returns a :class:`PredictHandle` for
        :meth:`predict_collect` or :meth:`predict_collect_raw`: the step's
        outputs, the images' sizes and count, and on a CUDA device the
        outputs' copies to pinned host memory, queued after the step, with
        the event that marks them done.

        Spans (``utils/profiling.py``): ``mrcnn.submit`` around the call,
        ``mrcnn.prepare`` and ``mrcnn.predict_step`` inside it, and
        ``mrcnn.first_call`` around a call whose padded batch this process
        has not run."""
        plan = self._resize_plan(imgs)
        hp, wp = self._padded_hw(plan)
        dtype = torch.uint8 if self.uint8_input else torch.float32
        with profiling.first_call(("predict", len(plan), hp, wp, dtype)), \
                profiling.span("mrcnn.submit"):
            return self._submit(imgs, plan, (len(plan), hp, wp, 3), dtype)

    def _submit(self, imgs, plan, shape, dtype):
        cfg = self.config
        with profiling.span("mrcnn.prepare"):
            prepared, sizes, scales = self._prepare(imgs, plan)
        if self.uint8_input:
            # margin at the rounded mean -> ~0 after on-device subtraction
            fill = np.round(np.asarray(cfg.mean)).astype(np.uint8)
            x = torch.empty(shape, dtype=dtype, device=self.device)
            for c in range(3):
                x[..., c] = int(fill[c])
        else:
            x = torch.zeros(shape, dtype=dtype, device=self.device)
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
        with torch.no_grad(), profiling.span("mrcnn.predict_step"):
            if self.devices is None:
                out = predict_step(self._compute_params(), run_cfg, x,
                                   sizes_t, scales_t)
            else:
                out = make_parallel_predict_step(
                    lambda p, i, sz, sc: predict_step(p, run_cfg, i, sz, sc),
                    self.devices)(self._replica_params(), x, sizes_t,
                                  scales_t)
        first = next(iter(out.values()))
        if not first.is_cuda:
            return PredictHandle(out, sizes, len(plan))
        host, ready = _copy_back(out, first.device)
        self._newest = ready
        return PredictHandle(out, sizes, len(plan), host, ready)

    def predict_collect(
        self, handle
    ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray],
               List[np.ndarray]]:
        """Wait for a :meth:`predict_submit` handle, then apply the score
        threshold and paste the masks at full resolution on the host."""
        bboxes, probs, labels, scores, sizes = self.predict_collect_raw(
            handle)
        with profiling.span("mrcnn.paste"):
            masks = [paste_masks(b, p, *size)
                     for b, p, size in zip(bboxes, probs, sizes)]
        return bboxes, masks, labels, scores

    def predict_collect_raw(self, handle):
        """Wait for a :meth:`predict_submit` handle without pasting masks:
        per image ``(bboxes, mask_probs (R, M, M), labels, scores)`` after
        the score threshold, and the original sizes. Evaluation scores these
        box-locally (``add_boxlocal``), skipping the full-resolution paste
        (mask_rcnn_tpu/models/api.py:358-377).

        On a CUDA device the wait is for the handle's own ``ready`` event,
        that is for its batch and its copies back: batches submitted after
        it stay queued on the device. On the CPU the outputs are already
        there. The arrays returned are copies that share no memory with
        the handle. Spans: ``mrcnn.collect`` around the call,
        ``mrcnn.collect_wait`` around the wait; at its end the count
        ``mrcnn.collect_overlapped`` when the newest submitted batch is
        still running, so the device had work queued while the host goes
        on."""
        with profiling.span("mrcnn.collect"):
            out, sizes, n = handle
            with profiling.span("mrcnn.collect_wait"):
                if handle.ready is None:
                    out = {k: v.cpu().numpy() for k, v in out.items()}
                else:
                    handle.ready.synchronize()
                    out = {k: v.numpy() for k, v in handle.host.items()}
                    if not self._newest.query():
                        profiling.count("mrcnn.collect_overlapped")
            bboxes, probs, labels, scores = [], [], [], []
            for i in range(n):
                valid = out["valid"][i] & (out["scores"][i]
                                           >= self.score_thresh)
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
