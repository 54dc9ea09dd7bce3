"""ResNet-C4 backbone and the res5 head block, the port of
``mask_rcnn_tpu/models/resnet.py``.

Activations are NHWC at every function boundary, as in the JAX package.
``conv2d`` hands cuDNN/oneDNN the NCHW view ``x.permute(0, 3, 1, 2)``,
which for a contiguous NHWC tensor is an NCHW tensor in
``torch.channels_last`` memory format, and returns the NHWC view of its
channels-last output: no layout copy on either side.

  * the stem, conv1 7x7/2 pad 3 -> affine -> relu -> maxpool 3x3/2
    **pad 1** (:func:`stem_forward`): kernel K10 (``csrc/stem.cu``, one fused
    pass) on CUDA tensors, four torch ops on CPU tensors; the JAX package's
    space-to-depth rewrite equals the direct conv to ~1e-7 relative in f32
    (mask_rcnn_tpu/models/resnet.py:103-150);
  * res2 (stride 1), res3 (stride 2), res4 (stride 2) -> stride-16 C4
    features; res5 runs in the RoI head;
  * caffe/chainer bottleneck: the stride sits on the 1x1 ``conv1`` and the
    projection ``conv4``;
  * frozen BatchNorm as an unfolded per-channel affine (scale, bias), op for
    op like the JAX package.

Conv weights are OIHW (the bridge in ``utils/checkpoint.py`` transposes the
JAX package's HWIO).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mask_rcnn_tpu_torch.ops import _kernels

RESNET_N_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# (in, mid, out) channels for res2..res5.
STAGE_CHANNELS = {
    "res2": (64, 64, 256),
    "res3": (256, 128, 512),
    "res4": (512, 256, 1024),
    "res5": (1024, 512, 2048),
}
STAGE_STRIDES = {"res2": 1, "res3": 2, "res4": 2, "res5": 2}


def nchw(x):
    """NHWC tensor -> its NCHW (channels_last when contiguous) view."""
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW tensor -> its NHWC view."""
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, stride=1, padding=0):
    """NHWC conv; w is OIHW; symmetric integer padding."""
    return nhwc(F.conv2d(nchw(x), w, stride=stride, padding=padding))


def affine(x, params):
    """Per-channel scale/bias, the frozen-BN replacement."""
    return x * params["scale"] + params["bias"]


def max_pool_3x3_s2_p1(x):
    """3x3/2 max pool with pad=1 (implicit -inf padding)."""
    return nhwc(F.max_pool2d(nchw(x), kernel_size=3, stride=2, padding=1))


def stem_forward_plain(params, x):
    """conv1 7x7/2 pad3 -> affine -> relu -> maxpool 3x3/2 pad1, as four
    torch ops: x (N, H, W, 3) -> (N, ceil(H/4), ceil(W/4), 64) NHWC."""
    h = conv2d(x, params["conv1"]["W"], stride=2, padding=3)
    h = torch.relu(affine(h, params["bn1"]))
    return max_pool_3x3_s2_p1(h)


_STEM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stem_wants_grad(params, x) -> bool:
    """Whether autograd would need the stem's gradient: grad mode is on and
    the input or a stem parameter requires grad. K10 has no backward (conv1
    and bn1 are frozen in every configuration and ``extractor_forward`` cuts
    the gradient after res2), so :func:`stem_forward` refuses such a call on
    a CUDA tensor."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in (
        x, params["conv1"]["W"], params["bn1"]["scale"],
        params["bn1"]["bias"]))


def stem_forward(params, x):
    """The stem, conv1 7x7/2 pad3 -> affine -> relu -> maxpool 3x3/2 pad1:
    x (N, H, W, 3) -> (N, ceil(H/4), ceil(W/4), 64) NHWC, any H and W.

    A CPU tensor takes :func:`stem_forward_plain`; a CUDA tensor (contiguous
    NHWC, float32 or bfloat16, with the params of the same type) takes
    kernel K10, which sums the conv in float32, applies the affine and relu
    in float32 and rounds the pooled result once. K10 has no backward: with
    gradients wanted (:func:`stem_wants_grad`) the call raises."""
    if x.device.type == "cpu":
        return stem_forward_plain(params, x)
    if stem_wants_grad(params, x):
        raise RuntimeError(
            "stem_forward: kernel K10 has no backward; the stem is frozen "
            "(run it under torch.no_grad() or with parameters that do not "
            "require grad)")
    if x.dim() != 4 or x.shape[-1] != 3 or not x.is_contiguous() \
            or x.dtype not in _STEM_DTYPES:
        raise ValueError("stem_forward: x must be a contiguous (N, H, W, 3) "
                         f"float32 or bfloat16 tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")
    w = params["conv1"]["W"]
    scale, bias = params["bn1"]["scale"], params["bn1"]["bias"]
    if tuple(w.shape) != (64, 3, 7, 7) or scale.numel() != 64 \
            or bias.numel() != 64:
        raise ValueError(f"stem_forward: conv1/W must be (64, 3, 7, 7) and "
                         f"bn1 scale/bias 64 values, got {tuple(w.shape)}, "
                         f"{scale.numel()}, {bias.numel()}")
    for name, t in (("conv1/W", w), ("bn1/scale", scale), ("bn1/bias", bias)):
        if t.device != x.device:
            raise ValueError(f"stem_forward: {name} is on {t.device}, "
                             f"x on {x.device}")
    n, h, wd, _ = x.shape
    # (ky, kx, c, o) rows of float32, the layout the kernel stages in
    # shared memory
    wk = w.detach().permute(2, 3, 1, 0).reshape(147, 64).float().contiguous()
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    ph, pw = (h + 3) // 4, (wd + 3) // 4
    out = torch.empty((n, ph, pw, 64), dtype=x.dtype, device=x.device)
    err = _kernels.lib().mrcnn_stem_fwd(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _STEM_DTYPES[x.dtype], n, h, wd,
        _kernels.stream_ptr(x.device))
    _kernels.check(err, "mrcnn_stem_fwd")
    stem_forward.launches += 1
    return out


stem_forward.launches = 0


def bottleneck(params, x, stride=1, projection=False):
    h = conv2d(x, params["conv1"]["W"], stride=stride)
    h = torch.relu(affine(h, params["bn1"]))
    h = conv2d(h, params["conv2"]["W"], padding=1)
    h = torch.relu(affine(h, params["bn2"]))
    h = conv2d(h, params["conv3"]["W"])
    h = affine(h, params["bn3"])
    if projection:
        sc = conv2d(x, params["conv4"]["W"], stride=stride)
        sc = affine(sc, params["bn4"])
    else:
        sc = x
    return torch.relu(h + sc)


def building_block(params, x, n_blocks, stride):
    h = bottleneck(params["a"], x, stride=stride, projection=True)
    for i in range(1, n_blocks):
        h = bottleneck(params["b%d" % i], h)
    return h


def extractor_forward(params, x, n_layers=50, freeze_at="res2",
                      train=False, remat=False):
    """conv1 .. res4: (N, H, W, 3) -> (N, H/16, W/16, 1024) C4 features.

    With ``train``, ``freeze_at`` cuts the gradient after the named stage
    (``.detach()``, the reference's ``unchain_backward``), so the frozen
    stages get none, and ``remat`` recomputes each stage's activations in
    the backward pass (``torch.utils.checkpoint``) instead of keeping them.
    """
    blocks = RESNET_N_BLOCKS[n_layers]
    # With the cut right after res2 no gradient reaches the stem: run it
    # without autograd (its kernel, K10, has none).
    cut = train and freeze_at == "res2"
    with torch.no_grad() if cut else contextlib.nullcontext():
        h = stem_forward(params, x)
    for i, stage in enumerate(["res2", "res3", "res4"]):
        fn = functools.partial(building_block, params[stage],
                               n_blocks=blocks[i],
                               stride=STAGE_STRIDES[stage])
        h = checkpoint(fn, h, use_reentrant=False) if remat and train \
            else fn(h)
        if train and freeze_at == stage:
            h = h.detach()
    return h


def res5_forward(params, x, stride=2):
    """res5 on pooled RoI features: (R, S, S, 1024) -> (R, S/stride,
    S/stride, 2048)."""
    return building_block(params, x, RESNET_N_BLOCKS[50][3], stride)


# ---------------------------------------------------------------------------
# Initialization: the JAX package's distributions
# (mask_rcnn_tpu/models/resnet.py:210-275), drawn from a torch.Generator
# (not the same random bits).

# From-scratch init attenuates each residual branch through its last affine
# (mask_rcnn_tpu/models/resnet.py:226-232); pretrained weights overwrite it.
RESIDUAL_AFFINE_SCALE = 0.1


def _conv_init(gen, kh, kw, cin, cout):
    """he_normal OIHW conv weight."""
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return torch.randn((cout, cin, kh, kw), generator=gen) * std


def _affine_init(c, scale=1.0):
    return {"scale": torch.full((c,), float(scale)), "bias": torch.zeros(c)}


def init_bottleneck(gen, cin, mid, cout, projection,
                    residual_scale=RESIDUAL_AFFINE_SCALE):
    p = {
        "conv1": {"W": _conv_init(gen, 1, 1, cin, mid)},
        "bn1": _affine_init(mid),
        "conv2": {"W": _conv_init(gen, 3, 3, mid, mid)},
        "bn2": _affine_init(mid),
        "conv3": {"W": _conv_init(gen, 1, 1, mid, cout)},
        "bn3": _affine_init(cout, residual_scale),
    }
    if projection:
        p["conv4"] = {"W": _conv_init(gen, 1, 1, cin, cout)}
        p["bn4"] = _affine_init(cout, residual_scale)
    return p


def init_building_block(gen, stage, n_blocks):
    cin, mid, cout = STAGE_CHANNELS[stage]
    p = {"a": init_bottleneck(gen, cin, mid, cout, True)}
    for i in range(1, n_blocks):
        p["b%d" % i] = init_bottleneck(gen, cout, mid, cout, False)
    return p


def init_extractor(gen, n_layers=50):
    blocks = RESNET_N_BLOCKS[n_layers]
    params = {
        "conv1": {"W": _conv_init(gen, 7, 7, 3, 64)},
        "bn1": _affine_init(64, 0.5),
    }
    for i, stage in enumerate(["res2", "res3", "res4"]):
        params[stage] = init_building_block(gen, stage, blocks[i])
    return params


def init_res5(gen, n_layers=50):
    return init_building_block(gen, "res5", RESNET_N_BLOCKS[n_layers][3])
