"""The flat RoIAlign (``ops/roi_align.py::roi_align``, kernels K4/K13 on the
card) and the flat branch of ``head_forward`` against the JAX package on the
CPU in float32: forward against JAX ``roi_align``, backward against
``jax.vjp`` of it, the head on flat rois under each pooler, and flat against
grouped inside the port."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import heads as jax_heads
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.models import heads
from mask_rcnn_tpu_torch.ops import roi_align as ra
from mask_rcnn_tpu_torch.utils import checkpoint

# the module: ``mask_rcnn_tpu.ops.roi_align`` is also the function's name
jax_ra = importlib.import_module("mask_rcnn_tpu.ops.roi_align")
SCALE = 1.0 / 4


def flat_inputs(seed=0, n=2, h=13, w=17, c=8, counts=(5, 2)):
    """Features (2, 13, 17, 8) and ragged flat rois (5 of image 0, 2 of
    image 1, interleaved) in image coordinates (x4), reaching past every
    border of the 52x68 image, with a degenerate one."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, h, w, c).astype(np.float32)
    r = sum(counts)
    hi = np.array([h, w, h, w], np.float32) / SCALE
    y1 = rng.uniform(-12, hi[0] - 4, r)
    x1 = rng.uniform(-12, hi[1] - 4, r)
    y2 = y1 + rng.uniform(1, hi[0] * 0.8, r)
    x2 = x1 + rng.uniform(1, hi[1] * 0.8, r)
    rois = np.stack([y1, x1, y2, x2], 1).astype(np.float32)
    rois[0] = (-10, -10, hi[0] + 10, hi[1] + 10)  # past every border
    rois[3] = (20, 20, 20, 20)  # zero extent
    idx = np.concatenate([np.full(k, i, np.int32)
                          for i, k in enumerate(counts)])
    order = np.random.RandomState(seed + 1).permutation(r)
    return feats, rois[order], idx[order]


CASES = [(bs, sr) for bs in (1, 2) for sr in (0, 2)]


@pytest.mark.parametrize("bin_stride,sampling_ratio", CASES)
def test_roi_align_matches_jax(bin_stride, sampling_ratio):
    feats, rois, idx = flat_inputs()
    p = 7
    want = np.asarray(jax_ra.roi_align(
        jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(idx), p, SCALE,
        sampling_ratio=sampling_ratio, bin_stride=bin_stride))
    got = ra.roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                       torch.from_numpy(idx), p, SCALE, sampling_ratio,
                       bin_stride)
    assert ra.roi_align.launches == 0  # CPU: the plain version
    # float32 both sides (JAX at HIGHEST precision), sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bin_stride,sampling_ratio", CASES)
def test_roi_align_backward_matches_jax_vjp(bin_stride, sampling_ratio):
    feats, rois, idx = flat_inputs(seed=3)
    p = 7
    g = np.random.RandomState(4).randn(len(rois), p, p, 8).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: jax_ra.roi_align(f, jnp.asarray(rois), jnp.asarray(idx), p,
                                   SCALE, sampling_ratio=sampling_ratio,
                                   bin_stride=bin_stride),
        jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    f = torch.from_numpy(feats).requires_grad_(True)
    out = ra.roi_align(f, torch.from_numpy(rois), torch.from_numpy(idx), p,
                       SCALE, sampling_ratio, bin_stride)
    (got,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    direct = ra.roi_align_backward(torch.from_numpy(g),
                                   torch.from_numpy(rois),
                                   torch.from_numpy(idx), feats.shape[:3],
                                   SCALE, sampling_ratio, bin_stride)
    assert torch.equal(got, direct)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_roi_align_chunks_agree():
    """The 512-roi chunking (JAX's ``roi_chunk``) changes nothing."""
    feats, rois, idx = flat_inputs(seed=5)
    args = (torch.from_numpy(feats), torch.from_numpy(rois),
            torch.from_numpy(idx), 7, SCALE, 0, 2)
    whole = ra.roi_align_plain(*args)
    chunked = ra.roi_align_plain(*args, roi_chunk=3)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_flat_matches_grouped():
    """Equal counts per image: flat rois with their indices give the
    grouped result, forward and backward."""
    feats, _, _ = flat_inputs()
    rng = np.random.RandomState(6)
    grouped = np.stack([flat_inputs(seed=s, counts=(4,))[1]
                        for s in (7, 8)])
    idx = np.repeat(np.arange(2, dtype=np.int32), 4)
    f1 = torch.from_numpy(feats).requires_grad_(True)
    f2 = torch.from_numpy(feats).requires_grad_(True)
    want = ra.roi_align_grouped(f1, torch.from_numpy(grouped), 7, SCALE, 0, 2)
    got = ra.roi_align(f2, torch.from_numpy(grouped.reshape(8, 4)),
                       torch.from_numpy(idx), 7, SCALE, 0, 2)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy().reshape(8, 7, 7, 8),
                               rtol=1e-6, atol=1e-6)
    g = rng.randn(8, 7, 7, 8).astype(np.float32)
    (gw,) = torch.autograd.grad(want, f1, torch.from_numpy(g).reshape(
        want.shape))
    (gg,) = torch.autograd.grad(got, f2, torch.from_numpy(g))
    np.testing.assert_allclose(gg.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)


def test_roi_indices_out_of_range_are_refused():
    with pytest.raises(ValueError, match="roi_indices"):
        ra._check_roi_indices(torch.tensor([0, 2, 1], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="roi_indices"):
        ra._check_roi_indices(torch.tensor([-1], dtype=torch.int32), 2)
    ra._check_roi_indices(torch.tensor([0, 1, 1], dtype=torch.int32), 2)
    ra._check_roi_indices(torch.zeros(0, dtype=torch.int32), 2)


@pytest.fixture(scope="module")
def head_params():
    """The port's seeded head (4 classes) and its JAX-layout copy through
    the parameter bridge (exact, tests/test_torch_models.py)."""
    tparams = heads.init_head(torch.Generator().manual_seed(0), 4)
    return jax_ckpt.unflatten_params(checkpoint.params_to_numpy(tparams)), \
        tparams


def jax_pooling_func(pooling):
    return {"align": jax_ra.roi_align, "resize": jax_ra.crop_and_resize,
            "pooling": jax_ra.roi_pool}[pooling]


@pytest.mark.parametrize("pooling", ["align", "resize", "pooling"])
def test_flat_head_matches_jax(head_params, pooling):
    """``head_forward`` on flat rois with ragged indices against the JAX
    head, run op by op (under ``jax.jit`` XLA widens some ``roi_pool``
    bins, tests/test_torch_pooling.py)."""
    jparams, tparams = head_params
    rng = np.random.RandomState(9)
    feats = rng.randn(2, 4, 6, 1024).astype(np.float32)
    rois = np.stack([rng.uniform(0, 40, 6), rng.uniform(0, 60, 6),
                     rng.uniform(44, 64, 6), rng.uniform(64, 96, 6)],
                    1).astype(np.float32)
    idx = np.array([0, 1, 0, 0, 0, 1], np.int32)
    want = jax_heads.head_forward(
        jparams, jnp.asarray(feats), jnp.asarray(rois),
        jnp.asarray(idx), roi_size=14, spatial_scale=1 / 16,
        pooling_func=jax_pooling_func(pooling))
    with torch.no_grad():
        got = heads.head_forward(
            tparams, torch.from_numpy(feats), torch.from_numpy(rois),
            roi_size=14, spatial_scale=1 / 16, pooling=pooling,
            roi_indices=torch.from_numpy(idx))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        # tests/test_torch_models.py's head tolerance
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("pooling", ["align", "resize", "pooling"])
def test_flat_head_matches_grouped_head(head_params, pooling):
    _, tparams = head_params
    rng = np.random.RandomState(10)
    feats = torch.from_numpy(rng.randn(2, 4, 6, 1024).astype(np.float32))
    rois = np.stack([rng.uniform(0, 40, 6), rng.uniform(0, 60, 6),
                     rng.uniform(44, 64, 6), rng.uniform(64, 96, 6)],
                    1).astype(np.float32).reshape(2, 3, 4)
    kw = dict(roi_size=14, spatial_scale=1 / 16, pooling=pooling)
    with torch.no_grad():
        want = heads.head_forward(tparams, feats, torch.from_numpy(rois),
                                  **kw)
        got = heads.head_forward(
            tparams, feats, torch.from_numpy(rois.reshape(6, 4)),
            roi_indices=torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.int32),
            **kw)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_head_refuses_mixed_forms(head_params):
    _, tparams = head_params
    feats = torch.zeros(1, 4, 6, 1024)
    with pytest.raises(ValueError, match="roi_indices"):
        heads.head_forward(tparams, feats, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="roi_indices"):
        heads.head_forward(tparams, feats, torch.zeros(1, 3, 4),
                           roi_indices=torch.zeros(3, dtype=torch.int32))
