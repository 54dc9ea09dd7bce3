"""The RoI poolers and their gradients, the port of
``mask_rcnn_tpu/ops/roi_align.py``: Detectron RoIAlign on per-image rois
(``roi_align_grouped``, kernels K1/K7), and on flat rois with per-roi batch
indices RoIAlign (``roi_align``, K4/K13), the integer-crop bilinear resize
(``crop_and_resize``, K5/K11) and quantized max RoI pooling (``roi_pool``,
K6/K12). ``POOLING_FUNCS`` maps ``MaskRCNNConfig.pooling`` to them.

:func:`roi_align_grouped` is the wrapper: a CPU tensor goes to the plain
torch version :func:`roi_align_grouped_plain`, a CUDA tensor to the
hand-written kernel K1 (``csrc/roi_align.cu``). With gradients on it runs
through :class:`RoIAlignGroupedFn`, whose backward is kernel K7
(:func:`roi_align_grouped_backward`, same source) or its plain version. The
plain version keeps the JAX package's separable-matrix formulation

    out[n, r, p, q, c] = sum_h sum_w Ay[n, r, p, h] * Ax[n, r, q, w] * f[n, h, w, c]

in float32, and its backward is the explicit transpose of the two einsums;
the kernels sum the same bilinear taps per sample, so the two differ by
summation order only.

Semantics (Detectron, mask_rcnn_tpu/ops/roi_align.py:22-27): rois scaled by
``spatial_scale``; ``extent = max(end - start, 1)``; samples at
``start + p*bin + (s+.5)*bin/grid``; adaptive grid ``ceil(extent/pooled)``
when ``sampling_ratio == 0``; samples with ``y < -1 or y > H`` are skipped
but still counted in the divisor; low clamp ``y <= 0 -> 0``; high clamp
``y_low >= H-1 -> y = y_low = H-1``. No gradient flows to the rois
(``stop_gradient``, mask_rcnn_tpu/ops/roi_align.py:113).
"""

from __future__ import annotations

import torch

from mask_rcnn_tpu_torch.ops import _kernels


def _interp_matrix(start, bin_size, grid, pooled, max_grid, axis_size,
                   bin_stride):
    """Per-roi 1-D interpolation matrices (..., pooled, axis_size), rows
    scaled by 1/grid. ``start``/``bin_size`` are (...,) float32, ``grid``
    (...,) int."""
    dev = start.device
    p_idx = torch.arange(pooled, dtype=torch.float32, device=dev) * bin_stride
    s_idx = torch.arange(max_grid, dtype=torch.float32, device=dev)
    gridf = grid.to(torch.float32)[..., None, None]

    # coord[..., p, s] = start + p*bin + (s + .5) * bin / grid
    coord = (
        start[..., None, None]
        + p_idx[:, None] * bin_size[..., None, None]
        + (s_idx + 0.5) * (bin_size[..., None, None] / gridf)
    )
    valid = (s_idx < gridf) & (coord >= -1.0) & (coord <= axis_size)

    c = torch.clamp(coord, min=0.0)
    low = torch.floor(c).to(torch.int64)
    at_edge = low >= axis_size - 1
    low = torch.where(at_edge, axis_size - 1, low)
    high = torch.where(at_edge, low, low + 1)
    lw = torch.where(at_edge, 0.0, c - low.to(torch.float32))
    hw = 1.0 - lw

    w_scale = valid.to(torch.float32) / gridf
    rows = torch.arange(axis_size, device=dev)
    contrib = (hw * w_scale)[..., None] * (rows == low[..., None]) + (
        lw * w_scale
    )[..., None] * (rows == high[..., None])
    return contrib.sum(dim=-2)


def _roi_align_matrices(rois, h, w, out_size, spatial_scale,
                        sampling_ratio, bin_stride):
    """Per-roi interpolation matrices ay (N, R, P, H) and ax (N, R, P, W)
    of rois (N, R, 4) (y1, x1, y2, x2) in image coordinates."""
    p = out_size
    rois = rois.to(torch.float32)
    start_y = rois[..., 0] * spatial_scale
    start_x = rois[..., 1] * spatial_scale
    extent_y = torch.clamp(rois[..., 2] * spatial_scale - start_y, min=1.0)
    extent_x = torch.clamp(rois[..., 3] * spatial_scale - start_x, min=1.0)

    full = p * bin_stride
    # Divide by a tensor: on CUDA a division by a Python scalar multiplies
    # by its rounded reciprocal, which moves sample positions by an ulp and
    # can flip the discontinuous skip rule against the kernel.
    bin_y = extent_y / torch.full_like(extent_y, full)
    bin_x = extent_x / torch.full_like(extent_x, full)
    if sampling_ratio > 0:
        max_gy = max_gx = int(sampling_ratio)
        grid_y = torch.full_like(start_y, sampling_ratio, dtype=torch.int64)
        grid_x = grid_y
    else:
        # extent <= feature size for clipped proposals, so the bound is
        # ceil(size / pooled)
        max_gy = -(-h // full)
        max_gx = -(-w // full)
        grid_y = torch.clamp(torch.ceil(bin_y).to(torch.int64), 1, max_gy)
        grid_x = torch.clamp(torch.ceil(bin_x).to(torch.int64), 1, max_gx)

    ay = _interp_matrix(start_y, bin_y, grid_y, p, max_gy, h, bin_stride)
    ax = _interp_matrix(start_x, bin_x, grid_x, p, max_gx, w, bin_stride)
    return ay, ax


def roi_align_grouped_plain(features, rois, out_size, spatial_scale,
                            sampling_ratio=0, bin_stride=1):
    """Plain torch RoIAlign: features (N, H, W, C), rois (N, R, 4)
    (y1, x1, y2, x2) in image coordinates -> (N, R, P, P, C) in the feature
    dtype, computed in float32.

    ``bin_stride`` s computes bins (0, s, 2s, ...) of a virtual ``P*s``
    grid: identical to the full grid sliced ``[::s, ::s]``.
    """
    n, h, w, c = features.shape
    ay, ax = _roi_align_matrices(rois, h, w, out_size, spatial_scale,
                                 sampling_ratio, bin_stride)
    f = features.to(torch.float32)
    # Contract the longer spatial axis first so the intermediate keeps the
    # shorter one.
    if w <= h:
        t = torch.einsum("nrph,nhwc->nrpwc", ay, f)
        out = torch.einsum("nrqw,nrpwc->nrpqc", ax, t)
    else:
        t = torch.einsum("nrqw,nhwc->nrqhc", ax, f)
        out = torch.einsum("nrph,nrqhc->nrpqc", ay, t)
    return out.to(features.dtype)


def roi_align_grouped_backward_plain(grad_out, rois, feat_hw, spatial_scale,
                                     sampling_ratio=0, bin_stride=1):
    """Plain RoIAlign backward: the explicit transpose of the two einsums
    of :func:`roi_align_grouped_plain`. grad_out (N, R, P, P, C) -> the
    features' grad (N, H, W, C) in grad_out's dtype, computed in float32.
    The rois get no gradient (``stop_gradient`` at
    mask_rcnn_tpu/ops/roi_align.py:113)."""
    h, w = feat_hw
    ay, ax = _roi_align_matrices(rois, h, w, grad_out.shape[2],
                                 spatial_scale, sampling_ratio, bin_stride)
    g = grad_out.to(torch.float32)
    t = torch.einsum("nrqw,nrpqc->nrpwc", ax, g)
    df = torch.einsum("nrph,nrpwc->nhwc", ay, t)
    return df.to(grad_out.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_rois(rois, n, device):
    if (rois.dim() != 3 or rois.shape[0] != n or rois.shape[2] != 4
            or rois.dtype != torch.float32 or not rois.is_contiguous()
            or rois.device != device):
        raise ValueError(
            "rois must be a contiguous float32 (N, R, 4) tensor on the "
            f"features' device, got {tuple(rois.shape)} {rois.dtype} "
            f"{rois.device}"
        )


def _check_cuda(x, name, layout):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != len(layout) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({', '.join(layout)})"
                         " tensor")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported {name} dtype {x.dtype}")


def _check_aligned(x, name="features"):
    """K1/K4 and K7/K13 read and write 16-byte channel groups: their input
    must start on a 16-byte boundary (a fresh or channels-last tensor does;
    a view at an odd offset into another may not)."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary, got an "
                         f"address {x.data_ptr() % 16} bytes past one")


def _aligned(grad):
    """The incoming gradient, contiguous and on a 16-byte boundary (copied
    when it is a view at an odd offset), as K7 and K13 take it."""
    grad = grad.contiguous()
    return grad if grad.data_ptr() % 16 == 0 else grad.clone()


def _check_args(out_size, sampling_ratio, bin_stride):
    if out_size < 1 or bin_stride < 1 or sampling_ratio < 0:
        raise ValueError("out_size, bin_stride >= 1 and sampling_ratio >= 0")


def _roi_align_forward(features, rois, out_size, spatial_scale,
                       sampling_ratio, bin_stride):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if features.device.type == "cpu":
        return roi_align_grouped_plain(features, rois, out_size,
                                       spatial_scale, sampling_ratio,
                                       bin_stride)
    _check_cuda(features, "features", "NHWC")
    _check_aligned(features)
    n, h, w, c = features.shape
    _check_cuda_rois(rois, n, features.device)
    _check_args(out_size, sampling_ratio, bin_stride)
    r = rois.shape[1]
    out = torch.empty((n, r, out_size, out_size, c), dtype=features.dtype,
                      device=features.device)
    err = _kernels.lib().mrcnn_roi_align_fwd(
        features.data_ptr(), rois.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[features.dtype], n, r, h, w, c, out_size,
        float(spatial_scale), int(sampling_ratio), int(bin_stride),
        _kernels.stream_ptr(features.device),
    )
    _kernels.check(err, "mrcnn_roi_align_fwd")
    roi_align_grouped.launches += 1
    return out


def roi_align_grouped_backward(grad_out, rois, feat_hw, spatial_scale,
                               sampling_ratio=0, bin_stride=1):
    """K7 wrapper, the RoIAlign backward: grad_out (N, R, P, P, C) -> the
    features' grad (N, H, W, C), contiguous NHWC in grad_out's dtype (its
    NCHW view is channels-last, like the backbone's activations). A CPU
    tensor takes :func:`roi_align_grouped_backward_plain`; a CUDA tensor
    takes the kernel, which sums in a float32 buffer with atomics (so the
    sums' order, and their last bits, vary from run to run); it must start
    on a 16-byte boundary, as a fresh contiguous tensor does."""
    if grad_out.device.type == "cpu":
        return roi_align_grouped_backward_plain(
            grad_out, rois, feat_hw, spatial_scale, sampling_ratio,
            bin_stride)
    _check_cuda(grad_out, "grad_out", "NRPPC")
    _check_aligned(grad_out, "grad_out")
    n, r, p, p2, c = grad_out.shape
    if p != p2:
        raise ValueError(f"grad_out must have square bins, got {p}x{p2}")
    h, w = feat_hw
    _check_cuda_rois(rois, n, grad_out.device)
    _check_args(p, sampling_ratio, bin_stride)
    acc = torch.zeros((n, h, w, c), dtype=torch.float32,
                      device=grad_out.device)
    err = _kernels.lib().mrcnn_roi_align_bwd(
        grad_out.data_ptr(), rois.data_ptr(), acc.data_ptr(),
        _DTYPE_CODE[grad_out.dtype], n, r, h, w, c, p,
        float(spatial_scale), int(sampling_ratio), int(bin_stride),
        _kernels.stream_ptr(grad_out.device),
    )
    _kernels.check(err, "mrcnn_roi_align_bwd")
    roi_align_grouped_backward.launches += 1
    return acc.to(grad_out.dtype)


roi_align_grouped_backward.launches = 0


class RoIAlignGroupedFn(torch.autograd.Function):
    """RoIAlign with its gradient: K1 forward and K7 backward on CUDA
    tensors, the plain pair on CPU tensors. Only the features get a
    gradient."""

    @staticmethod
    def forward(ctx, features, rois, out_size, spatial_scale,
                sampling_ratio, bin_stride):
        ctx.save_for_backward(rois)
        ctx.args = (tuple(features.shape[1:3]), spatial_scale,
                    sampling_ratio, bin_stride)
        return _roi_align_forward(features, rois, out_size, spatial_scale,
                                  sampling_ratio, bin_stride)

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        grad = roi_align_grouped_backward(_aligned(grad_out), rois,
                                          *ctx.args)
        return grad, None, None, None, None, None


def roi_align_grouped(features, rois, out_size, spatial_scale,
                      sampling_ratio=0, bin_stride=1):
    """RoIAlign on per-image rois; see :func:`roi_align_grouped_plain`.

    On the GPU ``features`` must be NHWC bytes: a contiguous (N, H, W, C)
    tensor starting on a 16-byte boundary, which is what an NCHW
    ``torch.channels_last`` activation gives under ``.permute(0, 2, 3, 1)``
    without a copy. ``rois`` must be a
    contiguous float32 (N, R, 4) tensor on the same device. With gradients
    on, the call goes through :class:`RoIAlignGroupedFn`, whose backward is
    K7; the rois never get a gradient.
    """
    if torch.is_grad_enabled() and features.requires_grad:
        return RoIAlignGroupedFn.apply(features, rois.detach(), out_size,
                                       spatial_scale, sampling_ratio,
                                       bin_stride)
    return _roi_align_forward(features, rois, out_size, spatial_scale,
                              sampling_ratio, bin_stride)


roi_align_grouped.launches = 0


# ---------------------------------------------------------------------------
# Flat RoIAlign: rois (R, 4) with per-roi image indices (R,), kernels K4
# (forward) and K13 (backward), the port of
# mask_rcnn_tpu/ops/roi_align.py::roi_align (149-232). The head's public form
# for callers with ragged roi counts per image.


def _roi_align_flat_chunks(rois, roi_indices, feat_shape, out_size,
                           spatial_scale, sampling_ratio, bin_stride,
                           roi_chunk):
    """Per chunk of rois: (slice, ay (r, P, N*H), ax (r, P, W)); each roi's
    y matrix sits at the row offset ``roi_indices * H`` of the (N*H, W, C)
    features, as in the JAX package's ``_roi_align_matrices``."""
    n, h, w = feat_shape
    for sl in _roi_chunks(rois.shape[0], roi_chunk):
        ay, ax = _roi_align_matrices(rois[sl], h, w, out_size, spatial_scale,
                                     sampling_ratio, bin_stride)
        onehot = torch.nn.functional.one_hot(
            roi_indices[sl].to(torch.int64), n).to(torch.float32)
        ay = (ay[:, :, None, :] * onehot[:, None, :, None]).reshape(
            ay.shape[0], out_size, n * h)
        yield sl, ay, ax


def roi_align_plain(features, rois, roi_indices, out_size, spatial_scale,
                    sampling_ratio=0, bin_stride=1, roi_chunk=512):
    """Plain torch RoIAlign on flat rois: features (N, H, W, C), rois (R, 4)
    (y1, x1, y2, x2) in image coordinates, roi_indices (R,) in [0, N) ->
    (R, P, P, C) in the feature dtype, computed in float32 as the JAX
    package's two einsums over separable matrices, ``roi_chunk`` rois at a
    time (the semantics of :func:`roi_align_grouped_plain`)."""
    n, h, w, c = features.shape
    f = features.to(torch.float32).reshape(n * h, w, c)
    out = torch.empty((rois.shape[0], out_size, out_size, c),
                      dtype=features.dtype, device=features.device)
    for sl, ay, ax in _roi_align_flat_chunks(
            rois, roi_indices, (n, h, w), out_size, spatial_scale,
            sampling_ratio, bin_stride, roi_chunk):
        # contract the longer spatial axis first (roi_align.py:197-220)
        if n * h <= w:
            t = torch.einsum("rqw,hwc->rqhc", ax, f)
            out[sl] = torch.einsum("rph,rqhc->rpqc", ay, t)
        else:
            t = torch.einsum("rph,hwc->rpwc", ay, f)
            out[sl] = torch.einsum("rqw,rpwc->rpqc", ax, t)
    return out


def roi_align_backward_plain(grad_out, rois, roi_indices, feat_shape,
                             spatial_scale, sampling_ratio=0, bin_stride=1,
                             roi_chunk=512):
    """Plain flat RoIAlign backward: the explicit transpose of
    :func:`roi_align_plain`'s einsums. grad_out (R, P, P, C) -> the
    features' grad (N, H, W, C) in grad_out's dtype, summed in float32; the
    rois get none (``stop_gradient``, mask_rcnn_tpu/ops/roi_align.py:113)."""
    n, h, w = feat_shape
    c = grad_out.shape[-1]
    g = grad_out.to(torch.float32)
    df = torch.zeros((n * h, w, c), dtype=torch.float32,
                     device=grad_out.device)
    for sl, ay, ax in _roi_align_flat_chunks(
            rois, roi_indices, feat_shape, grad_out.shape[1], spatial_scale,
            sampling_ratio, bin_stride, roi_chunk):
        t = torch.einsum("rqw,rpqc->rpwc", ax, g[sl])
        df += torch.einsum("rph,rpwc->hwc", ay, t)
    return df.reshape(n, h, w, c).to(grad_out.dtype)


def _check_roi_indices(roi_indices, n):
    """Refuse an image index outside [0, N): one read of the indices' range
    on the host (a synchronisation) before the kernel sees them."""
    if roi_indices.numel():
        lo, hi = torch.aminmax(roi_indices)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= n:
            raise ValueError(f"roi_indices must lie in [0, {n}), got "
                             f"[{lo}, {hi}]")


def _roi_align_flat_forward(features, rois, roi_indices, out_size,
                            spatial_scale, sampling_ratio, bin_stride):
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, roi_indices, out_size,
                               spatial_scale, sampling_ratio, bin_stride)
    _check_cuda(features, "features", "NHWC")
    _check_aligned(features)
    _check_cuda_flat(rois, roi_indices, features.device)
    _check_args(out_size, sampling_ratio, bin_stride)
    n, h, w, c = features.shape
    _check_roi_indices(roi_indices, n)
    r = rois.shape[0]
    out = torch.empty((r, out_size, out_size, c), dtype=features.dtype,
                      device=features.device)
    err = _kernels.lib().mrcnn_roi_align_flat_fwd(
        features.data_ptr(), rois.data_ptr(), roi_indices.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[features.dtype], n, r, h, w, c, out_size,
        float(spatial_scale), int(sampling_ratio), int(bin_stride),
        _kernels.stream_ptr(features.device))
    _kernels.check(err, "mrcnn_roi_align_flat_fwd")
    roi_align.launches += 1
    return out


def roi_align_backward(grad_out, rois, roi_indices, feat_shape,
                       spatial_scale, sampling_ratio=0, bin_stride=1):
    """K13 wrapper, the flat RoIAlign backward: grad_out (R, P, P, C) -> the
    features' grad (N, H, W, C), contiguous NHWC in grad_out's dtype. A CPU
    tensor takes :func:`roi_align_backward_plain`; a CUDA tensor the kernel
    (K7's kernel with the roi's image from its index; float32 atomics,
    cast at the end; grad_out on a 16-byte boundary)."""
    if grad_out.device.type == "cpu":
        return roi_align_backward_plain(grad_out, rois, roi_indices,
                                        feat_shape, spatial_scale,
                                        sampling_ratio, bin_stride)
    _check_cuda(grad_out, "grad_out", "RPPC")
    _check_aligned(grad_out, "grad_out")
    r, p, p2, c = grad_out.shape
    if p != p2:
        raise ValueError(f"grad_out must have square bins, got {p}x{p2}")
    _check_cuda_flat(rois, roi_indices, grad_out.device)
    _check_args(p, sampling_ratio, bin_stride)
    n, h, w = feat_shape
    _check_roi_indices(roi_indices, n)
    acc = torch.zeros((n, h, w, c), dtype=torch.float32,
                      device=grad_out.device)
    err = _kernels.lib().mrcnn_roi_align_flat_bwd(
        grad_out.data_ptr(), rois.data_ptr(), roi_indices.data_ptr(),
        acc.data_ptr(), _DTYPE_CODE[grad_out.dtype], n, r, h, w, c, p,
        float(spatial_scale), int(sampling_ratio), int(bin_stride),
        _kernels.stream_ptr(grad_out.device))
    _kernels.check(err, "mrcnn_roi_align_flat_bwd")
    roi_align_backward.launches += 1
    return acc.to(grad_out.dtype)


roi_align_backward.launches = 0


class RoIAlignFn(torch.autograd.Function):
    """Flat RoIAlign with its gradient: K4 forward and K13 backward on CUDA
    tensors, the plain pair on CPU tensors. Only the features get a
    gradient."""

    @staticmethod
    def forward(ctx, features, rois, roi_indices, out_size, spatial_scale,
                sampling_ratio, bin_stride):
        ctx.save_for_backward(rois, roi_indices)
        ctx.args = (tuple(features.shape[:3]), spatial_scale, sampling_ratio,
                    bin_stride)
        return _roi_align_flat_forward(features, rois, roi_indices, out_size,
                                       spatial_scale, sampling_ratio,
                                       bin_stride)

    @staticmethod
    def backward(ctx, grad_out):
        rois, roi_indices = ctx.saved_tensors
        grad = roi_align_backward(_aligned(grad_out), rois, roi_indices,
                                  *ctx.args)
        return grad, None, None, None, None, None, None


def roi_align(features, rois, roi_indices, out_size, spatial_scale,
              sampling_ratio=0, bin_stride=1):
    """RoIAlign on flat rois with per-roi image indices; see
    :func:`roi_align_plain`. On the GPU ``features`` must be contiguous
    NHWC on a 16-byte boundary, ``rois`` a contiguous float32 (R, 4) tensor
    and ``roi_indices`` a contiguous int32 (R,) tensor in [0, N) on the
    same device (checked on the host before the launch). With gradients
    on, the call goes through :class:`RoIAlignFn`, whose backward is K13;
    the rois never get a gradient."""
    if torch.is_grad_enabled() and features.requires_grad:
        return RoIAlignFn.apply(features, rois.detach(), roi_indices,
                                out_size, spatial_scale, sampling_ratio,
                                bin_stride)
    return _roi_align_flat_forward(features, rois, roi_indices, out_size,
                                   spatial_scale, sampling_ratio, bin_stride)


roi_align.launches = 0


# ---------------------------------------------------------------------------
# Flat rois (R, 4) with per-roi batch indices (R,): the reference's
# alternate poolers, ``--pooling-func resize`` and ``--pooling-func
# pooling``. No gradient flows to the rois (``stop_gradient``,
# mask_rcnn_tpu/ops/roi_align.py:324, 402).


def _check_cuda_flat(rois, roi_indices, device):
    if (rois.dim() != 2 or rois.shape[1] != 4
            or rois.dtype != torch.float32 or not rois.is_contiguous()
            or rois.device != device):
        raise ValueError(
            "rois must be a contiguous float32 (R, 4) tensor on the "
            f"features' device, got {tuple(rois.shape)} {rois.dtype} "
            f"{rois.device}"
        )
    if (roi_indices.shape != rois.shape[:1]
            or roi_indices.dtype != torch.int32
            or not roi_indices.is_contiguous()
            or roi_indices.device != device):
        raise ValueError(
            "roi_indices must be a contiguous int32 (R,) tensor on the "
            f"features' device, got {tuple(roi_indices.shape)} "
            f"{roi_indices.dtype} {roi_indices.device}"
        )


def _launch_flat(name, ptrs, dtype, feat_shape, r, c, out_size,
                 spatial_scale, device):
    """Call the C entry point ``name`` of ``csrc/roi_pool.cu``: pointers,
    then (dtype, N, R, H, W, C, P, spatial_scale, stream)."""
    n, h, w = feat_shape
    err = getattr(_kernels.lib(), name)(
        *ptrs, _DTYPE_CODE[dtype], n, r, h, w, c, out_size,
        float(spatial_scale), _kernels.stream_ptr(device))
    _kernels.check(err, name)


def _roi_chunks(r, roi_chunk):
    return [slice(s, min(s + roi_chunk, r)) for s in range(0, r, roi_chunk)]


# -- crop_and_resize: K5 forward, K11 backward -------------------------------


def _crop_resize_matrix(lo, hi, axis_size, total, offset, out_size,
                        spatial_scale):
    """(R, P, total) align-corners interpolation matrix of the integer crop
    ``[round(s*lo), max(round(s*hi), round(s*lo) + 1))`` along one axis, its
    rows shifted by ``offset`` (R,) (mask_rcnn_tpu/ops/roi_align.py:326-343).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    dev = lo.device
    lo_i = torch.round(lo * spatial_scale)
    hi_i = torch.maximum(torch.round(hi * spatial_scale), lo_i + 1.0)
    crop = hi_i - lo_i
    i_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    # a true division, by a tensor (see _roi_align_matrices)
    step = (crop - 1.0) / torch.full_like(crop, max(out_size - 1, 1))
    coord = lo_i[:, None] + i_idx[None, :] * step[:, None]
    coord = torch.clamp(coord, 0.0, axis_size - 1.0)
    low = torch.clamp(torch.floor(coord).to(torch.int64), max=axis_size - 1)
    high = torch.clamp(low + 1, max=axis_size - 1)
    lw = coord - low.to(torch.float32)
    hw = 1.0 - lw
    rows = torch.arange(total, device=dev)
    off = offset[:, None]
    return (hw[..., None] * (rows == (low + off)[..., None])
            + lw[..., None] * (rows == (high + off)[..., None]))


def _crop_resize_chunks(rois, roi_indices, feat_shape, out_size,
                        spatial_scale, roi_chunk):
    """Per chunk of rois: (slice, ay (r, P, N*H), ax (r, P, W)); the batch
    offset is folded into the y axis of the (N*H, W, C) features."""
    n, h, w = feat_shape
    rois = rois.to(torch.float32)
    for sl in _roi_chunks(rois.shape[0], roi_chunk):
        rc = rois[sl]
        off_y = roi_indices[sl].to(torch.int64) * h
        ay = _crop_resize_matrix(rc[:, 0], rc[:, 2], h, n * h, off_y,
                                 out_size, spatial_scale)
        ax = _crop_resize_matrix(rc[:, 1], rc[:, 3], w, w,
                                 torch.zeros_like(off_y), out_size,
                                 spatial_scale)
        yield sl, ay, ax


def crop_and_resize_plain(features, rois, roi_indices, out_size,
                          spatial_scale, roi_chunk=512):
    """Plain torch integer crop + align-corners bilinear resize
    (mask_rcnn_tpu/ops/roi_align.py:304-378): features (N, H, W, C), rois
    (R, 4) (y1, x1, y2, x2) in image coordinates, roi_indices (R,) -> (R, P,
    P, C) in the feature dtype, computed in float32 as two einsums over
    separable matrices, ``roi_chunk`` rois at a time."""
    n, h, w, c = features.shape
    f = features.to(torch.float32).reshape(n * h, w, c)
    out = torch.empty((rois.shape[0], out_size, out_size, c),
                      dtype=features.dtype, device=features.device)
    for sl, ay, ax in _crop_resize_chunks(rois, roi_indices, (n, h, w),
                                          out_size, spatial_scale, roi_chunk):
        t = torch.einsum("rph,hwc->rpwc", ay, f)
        out[sl] = torch.einsum("rqw,rpwc->rpqc", ax, t)
    return out


def crop_and_resize_backward_plain(grad_out, rois, roi_indices, feat_shape,
                                   spatial_scale, roi_chunk=512):
    """Plain crop-and-resize backward: the explicit transpose of the two
    einsums of :func:`crop_and_resize_plain`. grad_out (R, P, P, C) -> the
    features' grad (N, H, W, C) in grad_out's dtype, summed in float32."""
    n, h, w = feat_shape
    c = grad_out.shape[-1]
    g = grad_out.to(torch.float32)
    df = torch.zeros((n * h, w, c), dtype=torch.float32,
                     device=grad_out.device)
    for sl, ay, ax in _crop_resize_chunks(rois, roi_indices, feat_shape,
                                          grad_out.shape[1], spatial_scale,
                                          roi_chunk):
        t = torch.einsum("rqw,rpqc->rpwc", ax, g[sl])
        df += torch.einsum("rph,rpwc->hwc", ay, t)
    return df.reshape(n, h, w, c).to(grad_out.dtype)


def _crop_and_resize_forward(features, rois, roi_indices, out_size,
                             spatial_scale):
    """K5 on CUDA tensors, the plain version on CPU tensors. The kernel
    reads and writes 16-byte channel vectors when C is a multiple of 8
    (bf16) or 4 (float32) and the features and the output start on 16-byte
    boundaries, and one channel a thread otherwise: its entry point picks
    the form, so no alignment is checked here."""
    if features.device.type == "cpu":
        return crop_and_resize_plain(features, rois, roi_indices, out_size,
                                     spatial_scale)
    _check_cuda(features, "features", "NHWC")
    _check_cuda_flat(rois, roi_indices, features.device)
    _check_args(out_size, 0, 1)
    n, h, w, c = features.shape
    r = rois.shape[0]
    out = torch.empty((r, out_size, out_size, c), dtype=features.dtype,
                      device=features.device)
    _launch_flat("mrcnn_crop_resize_fwd",
                 (features.data_ptr(), rois.data_ptr(),
                  roi_indices.data_ptr(), out.data_ptr()),
                 features.dtype, (n, h, w), r, c, out_size, spatial_scale,
                 features.device)
    crop_and_resize.launches += 1
    return out


def crop_and_resize_backward(grad_out, rois, roi_indices, feat_shape,
                             spatial_scale):
    """K11 wrapper, the crop-and-resize backward: grad_out (R, P, P, C) ->
    the features' grad (N, H, W, C), contiguous NHWC in grad_out's dtype. A
    CPU tensor takes :func:`crop_and_resize_backward_plain`; a CUDA tensor
    the kernel, which sums a row of cells' taps per feature column in
    registers and scatters them with float32 atomics (the sums' last bits
    vary from run to run), then casts at the end. It reads 16-byte channel
    vectors when C is a multiple of 8 (bf16) or 4 (float32) and grad_out
    starts on a 16-byte boundary, and one channel a thread otherwise."""
    if grad_out.device.type == "cpu":
        return crop_and_resize_backward_plain(grad_out, rois, roi_indices,
                                              feat_shape, spatial_scale)
    _check_cuda(grad_out, "grad_out", "RPPC")
    r, p, p2, c = grad_out.shape
    if p != p2:
        raise ValueError(f"grad_out must have square bins, got {p}x{p2}")
    _check_cuda_flat(rois, roi_indices, grad_out.device)
    n, h, w = feat_shape
    acc = torch.zeros((n, h, w, c), dtype=torch.float32,
                      device=grad_out.device)
    _launch_flat("mrcnn_crop_resize_bwd",
                 (grad_out.data_ptr(), rois.data_ptr(),
                  roi_indices.data_ptr(), acc.data_ptr()),
                 grad_out.dtype, feat_shape, r, c, p, spatial_scale,
                 grad_out.device)
    crop_and_resize_backward.launches += 1
    return acc.to(grad_out.dtype)


crop_and_resize_backward.launches = 0


class CropAndResizeFn(torch.autograd.Function):
    """Crop-and-resize with its gradient: K5 forward and K11 backward on
    CUDA tensors, the plain pair on CPU tensors. Only the features get a
    gradient."""

    @staticmethod
    def forward(ctx, features, rois, roi_indices, out_size, spatial_scale):
        ctx.save_for_backward(rois, roi_indices)
        ctx.args = (tuple(features.shape[:3]), spatial_scale)
        return _crop_and_resize_forward(features, rois, roi_indices,
                                        out_size, spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        rois, roi_indices = ctx.saved_tensors
        grad = crop_and_resize_backward(grad_out.contiguous(), rois,
                                        roi_indices, *ctx.args)
        return grad, None, None, None, None


def crop_and_resize(features, rois, roi_indices, out_size, spatial_scale):
    """Integer crop + align-corners bilinear resize; see
    :func:`crop_and_resize_plain`. On the GPU ``features`` must be
    contiguous NHWC, ``rois`` a contiguous float32 (R, 4) tensor and
    ``roi_indices`` a contiguous int32 (R,) tensor in [0, N) on the same
    device (a roi of another index pools zeros). With gradients on, the
    call goes through :class:`CropAndResizeFn`, whose backward is K11."""
    if torch.is_grad_enabled() and features.requires_grad:
        return CropAndResizeFn.apply(features, rois.detach(), roi_indices,
                                     out_size, spatial_scale)
    return _crop_and_resize_forward(features, rois, roi_indices, out_size,
                                    spatial_scale)


crop_and_resize.launches = 0


# -- roi_pool: K6 forward, K12 backward ---------------------------------------


def _pool_bounds(lo, hi, axis_size, out_size, spatial_scale):
    """Bins [start, end) (R, P) int64 along one axis, chainer's quantized
    rule (mask_rcnn_tpu/ops/roi_align.py:404-414): integer-rounded (half to
    even) roi ends, ``extent = max(hi - lo + 1, 1)``, bin p spans
    ``[floor(p*stride), ceil((p+1)*stride)) + lo`` clipped to [0, size].

    ``stride = extent / P`` is a true division, as chainer's and the JAX
    function run op by op compute it. Under ``jax.jit`` XLA rewrites that
    division by a constant as a multiply by the rounded reciprocal, which
    widens some bins by one row at common extents (3, 6, 9, 11, ... for
    P = 7 or 14); the port keeps the true division."""
    lo_i = torch.round(lo * spatial_scale)
    hi_i = torch.round(hi * spatial_scale)
    extent = torch.clamp(hi_i - lo_i + 1.0, min=1.0)
    stride = extent / torch.full_like(extent, out_size)
    ph = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    start = torch.floor(ph * stride[:, None]) + lo_i[:, None]
    end = torch.ceil((ph + 1.0) * stride[:, None]) + lo_i[:, None]
    return (torch.clamp(start, 0.0, axis_size).to(torch.int64),
            torch.clamp(end, 0.0, axis_size).to(torch.int64))


def _roi_pool_chunk(feats, bounds, off, h, w):
    """Max pooling of one chunk of rois: feats (N*H, W, C), bounds (ys, ye,
    xs, xe) each (r, P), off (r,) = batch index * H -> (r, P, P, C).

    The chained ``torch.maximum`` over the JAX function's static loops, in
    its order (mask_rcnn_tpu/ops/roi_align.py:434-466): rows first for every
    column, then columns, each starting from -inf and reading at most
    ``ceil(size / P) + 1`` rows or columns of a bin. ``torch.maximum`` splits
    a tie's gradient in half as ``lax.max`` does, so autograd through this
    function is the JAX gradient, tie weights included."""
    ys, ye, xs, xe = bounds
    r, p = ys.shape
    c = feats.shape[-1]
    smax_y = -(-h // p) + 1
    smax_x = -(-w // p) + 1
    neg_inf = torch.tensor(-torch.inf, dtype=feats.dtype, device=feats.device)

    acc = torch.full((r, p, w, c), -torch.inf, dtype=feats.dtype,
                     device=feats.device)
    for s in range(smax_y):
        row = torch.clamp(ys + s, 0, h - 1) + off[:, None]
        vals = feats[row.reshape(-1)].reshape(r, p, w, c)
        on = ((ys + s) < ye)[..., None, None]
        acc = torch.maximum(acc, torch.where(on, vals, neg_inf))

    tt = acc.transpose(1, 2).reshape(r * w, p, c)
    base = torch.arange(r, device=feats.device)[:, None] * w
    out = torch.full((r, p, p, c), -torch.inf, dtype=feats.dtype,
                     device=feats.device)
    for s in range(smax_x):
        col = torch.clamp(xs + s, 0, w - 1)
        vals = tt[(base + col).reshape(-1)].reshape(r, p, p, c)
        vals = vals.transpose(1, 2)  # (r, P_y, P_x, C)
        on = ((xs + s) < xe)[:, None, :, None]
        out = torch.maximum(out, torch.where(on, vals, neg_inf))
    return torch.where(torch.isfinite(out), out, 0.0)


def _roi_pool_setup(rois, roi_indices, feat_shape, out_size, spatial_scale):
    _, h, w = feat_shape
    rois = rois.to(torch.float32)
    ys, ye = _pool_bounds(rois[:, 0], rois[:, 2], h, out_size, spatial_scale)
    xs, xe = _pool_bounds(rois[:, 1], rois[:, 3], w, out_size, spatial_scale)
    return (ys, ye, xs, xe), roi_indices.to(torch.int64) * h


def roi_pool_plain(features, rois, roi_indices, out_size, spatial_scale,
                   roi_chunk=16):
    """Plain torch quantized max RoI pooling (chainer ``roi_pooling_2d``,
    mask_rcnn_tpu/ops/roi_align.py:381-479): features (N, H, W, C), rois
    (R, 4) (y1, x1, y2, x2) in image coordinates, roi_indices (R,) in
    [0, N) -> (R, P, P, C) in the feature dtype; an empty bin gives 0. The
    max is exact, so any dtype gives the same values. ``roi_chunk`` rois at
    a time: a (R, P, W, C) row stage at once would not fit."""
    n, h, w, c = features.shape
    feats = features.reshape(n * h, w, c)
    bounds, off = _roi_pool_setup(rois, roi_indices, (n, h, w), out_size,
                                  spatial_scale)
    outs = [_roi_pool_chunk(feats, [b[sl] for b in bounds], off[sl], h, w)
            for sl in _roi_chunks(rois.shape[0], roi_chunk)]
    if not outs:
        return features.new_zeros((0, out_size, out_size, c))
    return torch.cat(outs)


def roi_pool_backward_plain(grad_out, features, rois, roi_indices,
                            spatial_scale, roi_chunk=16):
    """Plain roi_pool backward: autograd of :func:`roi_pool_plain`'s max
    chain, chunk by chunk, in float32 (the max and its ties are the same in
    any dtype). grad_out (R, P, P, C) -> the features' grad (N, H, W, C) in
    grad_out's dtype."""
    n, h, w, c = features.shape
    f = features.detach().to(torch.float32).reshape(n * h, w, c)
    f.requires_grad_(True)
    g = grad_out.to(torch.float32)
    grad = torch.zeros_like(f)
    bounds, off = _roi_pool_setup(rois, roi_indices, (n, h, w),
                                  grad_out.shape[1], spatial_scale)
    with torch.enable_grad():
        for sl in _roi_chunks(rois.shape[0], roi_chunk):
            out = _roi_pool_chunk(f, [b[sl] for b in bounds], off[sl], h, w)
            grad += torch.autograd.grad(out, f, g[sl])[0]
    return grad.reshape(n, h, w, c).to(grad_out.dtype)


def _roi_pool_forward(features, rois, roi_indices, out_size, spatial_scale):
    """K6 on CUDA tensors, the plain version on CPU tensors."""
    if features.device.type == "cpu":
        return roi_pool_plain(features, rois, roi_indices, out_size,
                              spatial_scale)
    _check_cuda(features, "features", "NHWC")
    _check_cuda_flat(rois, roi_indices, features.device)
    _check_args(out_size, 0, 1)
    n, h, w, c = features.shape
    r = rois.shape[0]
    out = torch.empty((r, out_size, out_size, c), dtype=features.dtype,
                      device=features.device)
    _launch_flat("mrcnn_roi_pool_fwd",
                 (features.data_ptr(), rois.data_ptr(),
                  roi_indices.data_ptr(), out.data_ptr()),
                 features.dtype, (n, h, w), r, c, out_size, spatial_scale,
                 features.device)
    roi_pool.launches += 1
    return out


def roi_pool_backward(grad_out, features, rois, roi_indices, spatial_scale):
    """K12 wrapper, the roi_pool backward: grad_out (R, P, P, C) and the
    forward's features (N, H, W, C) of the same dtype -> the features' grad,
    contiguous NHWC in that dtype. The gradient is ``jax.grad``'s, not
    chainer's argmax rule: each chained maximum splits a tie in half, so the
    tied positions i1 < ... < im of one chain get 2^-(m-1), 2^-(m-1),
    2^-(m-2), ..., 1/2, and a feature gets the product of its row and column
    weights, summed over the bins that read it. A CPU tensor takes
    :func:`roi_pool_backward_plain`; a CUDA tensor the kernel (float32
    atomics, cast at the end), which reads 16-byte channel vectors when C
    is a multiple of 8 (bf16) or 4 (float32) and one channel a thread
    otherwise, and takes bins of at most 32 rows."""
    if grad_out.device.type == "cpu":
        return roi_pool_backward_plain(grad_out, features, rois, roi_indices,
                                       spatial_scale)
    _check_cuda(grad_out, "grad_out", "RPPC")
    _check_cuda(features, "features", "NHWC")
    r, p, p2, c = grad_out.shape
    if p != p2 or features.dtype != grad_out.dtype or features.shape[3] != c:
        raise ValueError("grad_out must be (R, P, P, C) of the features' "
                         f"dtype and channels, got {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} for {tuple(features.shape)} "
                         f"{features.dtype}")
    _check_cuda_flat(rois, roi_indices, grad_out.device)
    n, h, w, _ = features.shape
    if -(-h // p) + 1 > 32:
        raise ValueError(f"roi_pool_backward takes bins of at most 32 rows "
                         f"(ceil(H / P) + 1), got H={h}, P={p}")
    acc = torch.zeros((n, h, w, c), dtype=torch.float32,
                      device=grad_out.device)
    _launch_flat("mrcnn_roi_pool_bwd",
                 (grad_out.data_ptr(), features.data_ptr(), rois.data_ptr(),
                  roi_indices.data_ptr(), acc.data_ptr()),
                 grad_out.dtype, (n, h, w), r, c, p, spatial_scale,
                 grad_out.device)
    roi_pool_backward.launches += 1
    return acc.to(grad_out.dtype)


roi_pool_backward.launches = 0


class RoIPoolFn(torch.autograd.Function):
    """Quantized max RoI pooling with its gradient: K6 forward and K12
    backward on CUDA tensors, the plain pair on CPU tensors. Only the
    features get a gradient."""

    @staticmethod
    def forward(ctx, features, rois, roi_indices, out_size, spatial_scale):
        ctx.save_for_backward(features, rois, roi_indices)
        ctx.spatial_scale = spatial_scale
        return _roi_pool_forward(features, rois, roi_indices, out_size,
                                 spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        features, rois, roi_indices = ctx.saved_tensors
        grad = roi_pool_backward(grad_out.contiguous(), features, rois,
                                 roi_indices, ctx.spatial_scale)
        return grad, None, None, None, None


def roi_pool(features, rois, roi_indices, out_size, spatial_scale):
    """Quantized max RoI pooling; see :func:`roi_pool_plain`. On the GPU the
    inputs are those of :func:`crop_and_resize`, and K6 gives the plain
    version's values bit for bit: a bin that holds a NaN or +inf gives 0,
    as the JAX function's ``isfinite`` rule does. K6 reads 16-byte channel
    vectors when C is a multiple of 8 (bf16) or 4 (float32), the features
    start on a 16-byte boundary and its ring of ``ceil(W / P) + 1`` column
    maxima fits in shared memory (W / P up to ~100), and one channel a
    thread otherwise (W / P up to ~400 in float32, ~800 in bf16; past that
    the launch fails and the wrapper raises). With gradients on, the call
    goes through :class:`RoIPoolFn`, whose backward is K12."""
    if torch.is_grad_enabled() and features.requires_grad:
        return RoIPoolFn.apply(features, rois.detach(), roi_indices,
                               out_size, spatial_scale)
    return _roi_pool_forward(features, rois, roi_indices, out_size,
                             spatial_scale)


roi_pool.launches = 0


# ``MaskRCNNConfig.pooling`` -> pooler. "align" takes rois grouped per image
# (N, R, 4) (``head_forward`` routes flat rois to :func:`roi_align`); the
# other two take flat rois (R, 4) and batch indices (R,), as the JAX
# package's do.
POOLING_FUNCS = {
    "align": roi_align_grouped,
    "resize": crop_and_resize,
    "pooling": roi_pool,
}
