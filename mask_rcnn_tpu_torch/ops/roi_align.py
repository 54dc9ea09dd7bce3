"""Detectron RoIAlign on per-image rois and its gradient, the port of
``mask_rcnn_tpu/ops/roi_align.py::roi_align_grouped``.

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
    sums' order, and their last bits, vary from run to run)."""
    if grad_out.device.type == "cpu":
        return roi_align_grouped_backward_plain(
            grad_out, rois, feat_hw, spatial_scale, sampling_ratio,
            bin_stride)
    _check_cuda(grad_out, "grad_out", "NRPPC")
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
        grad = roi_align_grouped_backward(grad_out.contiguous(), rois,
                                          *ctx.args)
        return grad, None, None, None, None, None


def roi_align_grouped(features, rois, out_size, spatial_scale,
                      sampling_ratio=0, bin_stride=1):
    """RoIAlign on per-image rois; see :func:`roi_align_grouped_plain`.

    On the GPU ``features`` must be NHWC bytes: a contiguous (N, H, W, C)
    tensor, which is what an NCHW ``torch.channels_last`` activation gives
    under ``.permute(0, 2, 3, 1)`` without a copy. ``rois`` must be a
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
