"""Detectron RoIAlign on per-image rois, the port of
``mask_rcnn_tpu/ops/roi_align.py::roi_align_grouped``.

:func:`roi_align_grouped` is the wrapper: a CPU tensor goes to the plain
torch version :func:`roi_align_grouped_plain`, a CUDA tensor to the
hand-written kernel K1 (``csrc/roi_align.cu``). The plain version keeps the
JAX package's separable-matrix formulation

    out[n, r, p, q, c] = sum_h sum_w Ay[n, r, p, h] * Ax[n, r, q, w] * f[n, h, w, c]

in float32; the kernel sums the same bilinear taps per sample, so the two
differ by summation order only.

Semantics (Detectron, mask_rcnn_tpu/ops/roi_align.py:22-27): rois scaled by
``spatial_scale``; ``extent = max(end - start, 1)``; samples at
``start + p*bin + (s+.5)*bin/grid``; adaptive grid ``ceil(extent/pooled)``
when ``sampling_ratio == 0``; samples with ``y < -1 or y > H`` are skipped
but still counted in the divisor; low clamp ``y <= 0 -> 0``; high clamp
``y_low >= H-1 -> y = y_low = H-1``.
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


def roi_align_grouped_plain(features, rois, out_size, spatial_scale,
                            sampling_ratio=0, bin_stride=1):
    """Plain torch RoIAlign: features (N, H, W, C), rois (N, R, 4)
    (y1, x1, y2, x2) in image coordinates -> (N, R, P, P, C) in the feature
    dtype, computed in float32.

    ``bin_stride`` s computes bins (0, s, 2s, ...) of a virtual ``P*s``
    grid: identical to the full grid sliced ``[::s, ::s]``.
    """
    n, h, w, c = features.shape
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


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def roi_align_grouped(features, rois, out_size, spatial_scale,
                      sampling_ratio=0, bin_stride=1):
    """RoIAlign on per-image rois; see :func:`roi_align_grouped_plain`.

    On the GPU ``features`` must be NHWC bytes: a contiguous (N, H, W, C)
    tensor, which is what an NCHW ``torch.channels_last`` activation gives
    under ``.permute(0, 2, 3, 1)`` without a copy. ``rois`` must be a
    contiguous float32 (N, R, 4) tensor on the same device.
    """
    if features.device.type == "cpu":
        return roi_align_grouped_plain(features, rois, out_size,
                                       spatial_scale, sampling_ratio,
                                       bin_stride)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError("features must be a contiguous (N, H, W, C) tensor")
    if features.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported feature dtype {features.dtype}")
    n, h, w, c = features.shape
    if (rois.dim() != 3 or rois.shape[0] != n or rois.shape[2] != 4
            or rois.dtype != torch.float32 or not rois.is_contiguous()
            or rois.device != features.device):
        raise ValueError(
            "rois must be a contiguous float32 (N, R, 4) tensor on the "
            f"features' device, got {tuple(rois.shape)} {rois.dtype} "
            f"{rois.device}"
        )
    if out_size < 1 or bin_stride < 1 or sampling_ratio < 0:
        raise ValueError("out_size, bin_stride >= 1 and sampling_ratio >= 0")
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


roi_align_grouped.launches = 0
