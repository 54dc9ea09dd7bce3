"""The port's alternate RoI poolers (``crop_and_resize``, ``roi_pool``) and
their gradients against the JAX package and the chainer oracle on the CPU,
and the RoI head under each pooler against the JAX head.

The JAX functions run op by op here, as the JAX package's own tests run
them: under ``jax.jit`` XLA turns ``roi_pool``'s ``extent / P`` into a
multiply by the rounded reciprocal, which widens some bins
(:func:`test_jitted_jax_roi_pool_widens_bins`); the port keeps the true
division of the op-by-op function and of chainer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import heads as jax_heads
from mask_rcnn_tpu.ops.roi_align import crop_and_resize as jax_crop_and_resize
from mask_rcnn_tpu.ops.roi_align import roi_pool as jax_roi_pool
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.models import heads
from mask_rcnn_tpu_torch.ops import roi_align
from mask_rcnn_tpu_torch.utils import checkpoint
from tests.oracles import random_boxes, roi_pool_np

N, H, W, C = 3, 9, 13, 5


def edge_rois(rng):
    """Flat rois (in image coordinates, feature stride 16) and their image
    indices: random boxes, and the edge cases first."""
    fixed = np.array([
        # scaled ends at exact halves: round half to even (2.5 -> 2, 3.5 -> 4)
        [40, 56, 120, 152], [8, 24, 72, 88],
        # extents 6, 7, 8, 13, 14, 15: p * extent / 7 at or near integers
        [0, 0, 80, 96], [16, 16, 112, 112], [0, 16, 112, 128],
        [0, 0, 192, 16], [0, 0, 208, 0], [16, 0, 240, 64],
        # tiny rois: crop 1, extent 1 (empty bins in roi_pool)
        [32, 32, 32, 32], [50, 60, 52, 61],
        # past the borders (clipped bins and clamped taps)
        [-40, -30, 60, 80], [100, 150, 200, 260], [-10, -10, 400, 400],
        # all zeros, as padded slots are
        [0, 0, 0, 0],
    ], np.float32)
    rois = np.concatenate([fixed, random_boxes(rng, 26, H * 16, W * 16,
                                               min_size=2)])
    idx = rng.randint(0, N, len(rois)).astype(np.int32)
    return rois, idx


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("out_size", [14, 7, 1])
def test_crop_and_resize_matches_jax(out_size):
    rng = np.random.RandomState(0)
    feats = rng.randn(N, H, W, C).astype(np.float32)
    rois, idx = edge_rois(rng)
    want = np.asarray(jax_crop_and_resize(feats, rois, idx, out_size, 1 / 16))
    jitted = np.asarray(jax.jit(jax_crop_and_resize, static_argnums=(3, 4))(
        feats, rois, idx, out_size, 1 / 16))
    f, r, i = torch_args(feats, rois, idx)
    # roi_chunk 8: several chunks and a ragged last one
    got = roi_align.crop_and_resize_plain(f, r, i, out_size, 1 / 16,
                                          roi_chunk=8).numpy()
    assert got.shape == want.shape
    # float32 on both sides, the taps summed in another order: 1e-5; the
    # jitted JAX step is a multiply by 1/(P-1), an ulp off, and the
    # interpolation is continuous
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        roi_align.crop_and_resize(f, r, i, out_size, 1 / 16).numpy(), got)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("out_size", [7, 14, 2])
def test_roi_pool_matches_jax_exactly(out_size, dtype):
    rng = np.random.RandomState(1)
    feats = rng.randn(N, H, W, C).astype(np.float32)
    # repeated values make ties; the max is exact either way
    feats[0, 2:6, 3:9] = 0.5
    feats = np.asarray(jnp.asarray(feats, dtype))
    rois, idx = edge_rois(rng)
    want = np.asarray(jax_roi_pool(feats, rois, idx, out_size, 1 / 16))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    f = torch.from_numpy(np.array(feats, np.float32)).to(tdtype)
    r, i = torch_args(rois, idx)
    got = roi_align.roi_pool_plain(f, r, i, out_size, 1 / 16, roi_chunk=5)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        roi_align.roi_pool(f, r, i, out_size, 1 / 16).float().numpy(),
        got.float().numpy())


def nonfinite_bin_oracle(feats, rois, idx, out_size):
    """Per bin and channel: 0 for an empty bin or one that holds a NaN, else
    its max, and 0 where that max is +inf or -inf (the JAX function's
    ``isfinite`` rule). The bins are the port's ``_pool_bounds``, read to at
    most ``ceil(size / P) + 1`` rows and columns as the JAX loops read them.
    Also returns how many (bin, channel) values hold a NaN, hold +inf, and
    hold -inf beside a finite max."""
    n, h, w, c = feats.shape
    r = torch.from_numpy(rois)
    ys, ye = (b.numpy() for b in roi_align._pool_bounds(
        r[:, 0], r[:, 2], h, out_size, 1 / 16))
    xs, xe = (b.numpy() for b in roi_align._pool_bounds(
        r[:, 1], r[:, 3], w, out_size, 1 / 16))
    ye = np.minimum(ye, ys + -(-h // out_size) + 1)
    xe = np.minimum(xe, xs + -(-w // out_size) + 1)
    out = np.zeros((len(rois), out_size, out_size, c), np.float32)
    counts = np.zeros(3, np.int64)
    for k in range(len(rois)):
        for py in range(out_size):
            for px in range(out_size):
                v = feats[idx[k], ys[k, py]:ye[k, py], xs[k, px]:xe[k, px]]
                v = v.reshape(-1, c)
                if not len(v):
                    continue
                nan = np.isnan(v).any(0)
                top = np.where(nan, np.inf, v).max(0)
                keep = ~nan & np.isfinite(top)
                out[k, py, px] = np.where(keep, top, 0.0)
                counts += [nan.sum(), (~nan & (top == np.inf)).sum(),
                           (keep & (v == -np.inf).any(0)).sum()]
    return out, counts


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_roi_pool_nonfinite_bins_give_zero(dtype):
    """A bin that holds a NaN or +inf pools to 0 (the JAX function's chained
    ``jnp.maximum`` propagates the NaN, then its ``isfinite`` rule zeroes
    the bin); -inf beside finite values is an ordinary value; a bin of only
    -inf pools to 0. The plain version agrees with the JAX function and
    with the oracle everywhere, in float32 and bf16."""
    rng = np.random.RandomState(12)
    feats = rng.randn(N, H, W, C).astype(np.float32)
    flat = feats.reshape(-1)
    spots = rng.choice(flat.size, 60, replace=False)
    flat[spots[:20]] = np.nan
    flat[spots[20:40]] = np.inf
    flat[spots[40:]] = -np.inf
    feats[2, 5:9, 9:13] = -np.inf  # whole bins of -inf
    feats = np.asarray(jnp.asarray(feats, dtype))
    rois, idx = edge_rois(rng)
    rois = np.concatenate([rois, [[80, 144, 200, 200]]]).astype(np.float32)
    idx = np.concatenate([idx, [2]]).astype(np.int32)
    f32 = np.array(feats, np.float32)
    for out_size in (7, 2):
        want = np.asarray(jax_roi_pool(feats, rois, idx, out_size, 1 / 16))
        tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
        f = torch.from_numpy(f32).to(tdtype)
        got = roi_align.roi_pool_plain(f, *torch_args(rois, idx), out_size,
                                       1 / 16, roi_chunk=5)
        oracle, counts = nonfinite_bin_oracle(f32, rois, idx, out_size)
        assert counts.min() > 0, counts  # each kind of bin is exercised
        np.testing.assert_array_equal(np.asarray(want, np.float32), oracle)
        np.testing.assert_array_equal(got.float().numpy(), oracle)
        # the bins of only -inf: 0
        assert (oracle[-1, out_size // 2:, out_size // 2:] == 0).all()


@pytest.mark.parametrize("out_size", [7, 14, 2])
def test_roi_pool_matches_chainer_oracle_exactly(out_size):
    rng = np.random.RandomState(2)
    feats = rng.randn(N, H, W, C).astype(np.float32)
    rois, idx = edge_rois(rng)
    # the oracle reads whole bins and divides in float64; the JAX function
    # reads at most ceil(size/P)+1 rows of a bin and divides in float32, so
    # leave out rois longer than the map (their bins can be longer) and
    # extents whose float32 and float64 bins differ (29, 57, ...: none here)
    ext = np.round(rois[:, 2:] / 16) - np.round(rois[:, :2] / 16) + 1
    keep = (ext[:, 0] <= H) & (ext[:, 1] <= W)
    assert keep.sum() > 30
    rois, idx = rois[keep], idx[keep]
    want = roi_pool_np(feats, rois, idx, out_size, 1 / 16)
    got = roi_align.roi_pool_plain(*torch_args(feats, rois, idx), out_size,
                                   1 / 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jitted_jax_roi_pool_widens_bins():
    """A seam of the reference, not of the port: under ``jax.jit`` the JAX
    ``roi_pool`` computes ``extent * (1/P)``; at extent 3 and P = 7, 7 *
    stride rounds above 3, so the last bin reads one row past the roi. The
    port, the op-by-op JAX function and chainer's oracle keep it inside."""
    feats = np.zeros((1, 8, 8, 1), np.float32)
    feats[0, 4, 1] = 5.0  # the row just below the roi (rows 1..3)
    rois = np.array([[16.0, 16.0, 48.0, 48.0]], np.float32)
    idx = np.zeros(1, np.int32)
    eager = np.asarray(jax_roi_pool(feats, rois, idx, 7, 1 / 16))
    jitted = np.asarray(jax.jit(jax_roi_pool, static_argnums=(3, 4))(
        feats, rois, idx, 7, 1 / 16))
    oracle = roi_pool_np(feats, rois, idx, 7, 1 / 16)
    got = roi_align.roi_pool_plain(*torch_args(feats, rois, idx), 7,
                                   1 / 16).numpy()
    assert jitted.max() == 5.0 and oracle.max() == 0.0
    np.testing.assert_array_equal(eager, oracle)
    np.testing.assert_array_equal(got, oracle)


def test_crop_and_resize_grad_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(N, H, W, C).astype(np.float32)
    rois, idx = edge_rois(rng)
    g = rng.randn(len(rois), 14, 14, C).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax_crop_and_resize(f, rois, idx, 14, 1 / 16),
                     feats)
    (want,) = vjp(g)
    f, r, i, gt = torch_args(feats, rois, idx, g)
    f.requires_grad_(True)
    roi_align.crop_and_resize(f, r, i, 14, 1 / 16).backward(gt)
    # float32 sums in another order: 1e-5 of the largest gradient
    want = np.asarray(want)
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    direct = roi_align.crop_and_resize_backward_plain(gt, r, i, (N, H, W),
                                                      1 / 16, roi_chunk=7)
    np.testing.assert_allclose(direct.numpy(), f.grad.numpy(), rtol=0,
                               atol=1e-6 * np.abs(want).max())


def jax_pool_grad(feats, rois, idx, out_size, g):
    _, vjp = jax.vjp(lambda f: jax_roi_pool(f, rois, idx, out_size, 1 / 16),
                     feats)
    return np.asarray(vjp(g)[0])


def test_roi_pool_grad_splits_ties_as_jax():
    """jax.grad of the chained maxima halves a tie at each step; on an
    all-zero map every position of a bin shares its gradient, 2^-(m-1) for
    the first of m tied rows and 2^-(m-k+1) for the k-th."""
    feats = np.zeros((1, 8, 8, 1), np.float32)
    rois = np.array([[0.0, 0.0, 63.0, 63.0]], np.float32)
    idx = np.zeros(1, np.int32)
    g = np.ones((1, 2, 2, 1), np.float32)
    want = jax_pool_grad(feats, rois, idx, 2, g)
    f, r, i, gt = torch_args(feats, rois, idx, g)
    f.requires_grad_(True)
    roi_align.roi_pool(f, r, i, 2, 1 / 16).backward(gt)
    np.testing.assert_array_equal(f.grad.numpy(), want)
    # roi rows 0..4, stride 2.5: bins [0, 3) and [2, 5), three rows each
    w3 = np.array([0.25, 0.25, 0.5])
    rows = np.zeros(8)
    rows[0:3] += w3
    rows[2:5] += w3
    np.testing.assert_array_equal(want[0, :, :, 0],
                                  np.outer(rows, rows).astype(np.float32))


@pytest.mark.parametrize("out_size", [7, 2])
def test_roi_pool_grad_matches_jax(out_size):
    rng = np.random.RandomState(4)
    # relu'd values on a coarse grid: many exact zeros and repeated values
    feats = np.maximum(rng.randint(-3, 3, (N, H, W, C)), 0).astype(np.float32)
    feats[1, :4, :5] = 0.0
    rois, idx = edge_rois(rng)
    # an integer cotangent: every product of a tie weight (a power of two)
    # and a sum of them is exact, so the gradients must be equal
    g = rng.randint(-4, 5, (len(rois), out_size, out_size, C))
    g = g.astype(np.float32)
    want = jax_pool_grad(feats, rois, idx, out_size, g)
    f, r, i, gt = torch_args(feats, rois, idx, g)
    f.requires_grad_(True)
    roi_align.roi_pool(f, r, i, out_size, 1 / 16).backward(gt)
    np.testing.assert_array_equal(f.grad.numpy(), want)
    # the plain forward's own autograd, unchunked, is the same reference
    f2 = f.detach().clone().requires_grad_(True)
    roi_align.roi_pool_plain(f2, r, i, out_size, 1 / 16,
                             roi_chunk=len(rois)).backward(gt)
    np.testing.assert_array_equal(f2.grad.numpy(), want)
    # a random cotangent: sums in another order, 1e-6 of the largest
    g = rng.randn(len(rois), out_size, out_size, C).astype(np.float32)
    want = jax_pool_grad(feats, rois, idx, out_size, g)
    got = roi_align.roi_pool_backward_plain(torch.from_numpy(g), f.detach(),
                                            r, i, 1 / 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("pooling,jax_fn", [("resize", jax_crop_and_resize),
                                            ("pooling", jax_roi_pool),
                                            ("align", None)])
def test_head_forward_matches_jax(pooling, jax_fn):
    rng = np.random.RandomState(5)
    n, h, w, r = 2, 5, 7, 6
    feats = np.maximum(rng.randn(n, h, w, 1024), 0).astype(np.float32)
    rois = np.stack([random_boxes(rng, r, h * 16, w * 16, min_size=4)
                     for _ in range(n)])
    rois[0, 0] = [0, 0, 0, 0]
    jparams = jax_heads.init_head(jax.random.PRNGKey(1), n_class=3)
    kw = {} if jax_fn is None else {"pooling_func": jax_fn}
    want = jax_heads.head_forward(jparams, jnp.asarray(feats),
                                  jnp.asarray(rois), None, **kw)
    tparams = checkpoint.params_from_numpy(
        jax_ckpt.flatten_params({"head": jparams}))["head"]
    with torch.no_grad():
        got = heads.head_forward(tparams, torch.from_numpy(feats),
                                 torch.from_numpy(rois), pooling=pooling)
    assert set(got) == set(want)
    for k in want:
        wk = np.asarray(want[k])
        assert tuple(got[k].shape) == wk.shape, k
        # float32 convs and matmuls in another order (test_torch_models.py)
        np.testing.assert_allclose(got[k].numpy(), wk, rtol=1e-4,
                                   atol=1e-4 * np.abs(wk).max(), err_msg=k)
