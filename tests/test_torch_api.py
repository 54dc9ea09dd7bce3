"""The port's ``MaskRCNNResNet`` against the JAX package's API on the CPU,
its cv2-free preparation against cv2, and the package's import hygiene."""

import contextlib
import json
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models.api import MaskRCNNResNet as JaxMaskRCNNResNet
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu.utils.masks import paste_masks as jax_paste_masks
from mask_rcnn_tpu_torch.models import mask_rcnn, rpn
from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet
from mask_rcnn_tpu_torch.utils import checkpoint
from mask_rcnn_tpu_torch.utils.masks import paste_masks, resize_bilinear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(
    n_layers=50, n_fg_class=3, min_size=48, max_size=64,
    anchor_scales=(4.0, 8.0),
    proposal_creator_params=dict(n_test_pre_nms=80, n_test_post_nms=16),
)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMaskRCNNResNet(**MODEL_KW)
    jcfg = jmodel.config
    tcfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=jcfg.n_fg_class, min_size=jcfg.min_size,
        max_size=jcfg.max_size, anchor_scales=jcfg.anchor_scales,
        proposal=rpn.ProposalConfig(**MODEL_KW["proposal_creator_params"],
                                    min_size=0.0),
    )
    params = checkpoint.params_from_numpy(
        jax_ckpt.flatten_params(jax.device_get(jmodel.params)))
    return jmodel, MaskRCNNResNet.from_config(tcfg, params)


@contextlib.contextmanager
def cv2_reference_path():
    """cv2's plain (non-IPP, non-SIMD) code path. Its optimized bilinear
    resize rounds coefficients its own way (up to 6.6e-3 on 0-255 data at
    an 800/480 upscale); the plain path is the one the port reproduces."""
    cv2.setUseOptimized(False)
    try:
        yield
    finally:
        cv2.setUseOptimized(True)


def images(seed=0):
    rng = np.random.RandomState(seed)
    return [
        rng.randint(0, 255, (3, 70, 90)).astype(np.float32),
        rng.randint(0, 255, (3, 50, 50)).astype(np.float32),
        rng.randint(0, 255, (3, 97, 61)).astype(np.float32),
    ]


@pytest.mark.parametrize("h,w,scale", [(70, 90, 48 / 70), (50, 50, 0.96),
                                       (480, 640, 800 / 480),
                                       (61, 97, 64 / 97), (16, 16, 2.0)])
def test_resize_matches_cv2(h, w, scale):
    rng = np.random.RandomState(h)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    with cv2_reference_path():
        want = cv2.resize(img, None, fx=scale, fy=scale)
        want1 = cv2.resize(img[..., 0], (w + 7, h + 3))
    got = resize_bilinear(torch.from_numpy(img), want.shape[0],
                          want.shape[1], scale, scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # dsize form, as the mask paste calls it
    got = resize_bilinear(torch.from_numpy(img[..., 0]), h + 3, w + 7)
    np.testing.assert_allclose(got.numpy(), want1, rtol=0, atol=1e-3)


def test_prepare_matches_cv2(models):
    jmodel, tmodel = models
    imgs = images()
    with cv2_reference_path():
        want, want_sizes, want_scales = jmodel.prepare(imgs)
    got, sizes, scales = tmodel.prepare(imgs)
    assert sizes == want_sizes and scales == want_scales
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3)


def test_paste_masks_matches_cv2():
    rng = np.random.RandomState(0)
    bbox = np.array([[3.2, 4.9, 40.3, 30.1], [-5.0, -3.0, 12.0, 70.0],
                     [20.0, 20.0, 20.4, 21.0], [50, 60, 90, 99]],
                    np.float32)
    probs = rng.uniform(0, 1, (4, 14, 14)).astype(np.float32)
    got = paste_masks(bbox, probs, 64, 80)
    with cv2_reference_path():
        want = jax_paste_masks(bbox, probs, 64, 80)
    assert got.shape == want.shape and got.dtype == bool
    assert (got == want).mean() >= 0.999


def test_predict_matches_jax_api(models):
    jmodel, tmodel = models
    imgs = images()
    with cv2_reference_path():
        want = jmodel.predict(imgs)
    got = tmodel.predict(imgs)
    assert sum(len(b) for b in want[0]) > 0
    for i in range(len(imgs)):
        np.testing.assert_array_equal(got[2][i], want[2][i])  # labels
        np.testing.assert_allclose(got[0][i], want[0][i], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[3][i], want[3][i], rtol=0, atol=1e-4)
        assert got[1][i].shape == want[1][i].shape
        if got[1][i].size:
            assert (got[1][i] == want[1][i]).mean() >= 0.999


def test_predict_stream_and_low_score_thresh(models):
    _, tmodel = models
    batches = [images(1)[:2], images(2)[2:]]
    streamed = list(tmodel.predict_stream(batches, depth=2))
    for batch, out in zip(batches, streamed):
        ref = tmodel.predict(batch)
        for a, b in zip(out, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # a threshold below the config's goes into the decode step
    base = sum(len(b) for b in tmodel.predict(batches[0])[0])
    tmodel.score_thresh = 0.0
    try:
        low = tmodel.predict(batches[0])
    finally:
        tmodel.score_thresh = 0.05
    assert sum(len(b) for b in low[0]) >= base
    assert all((s >= 0).all() for s in low[3])


def test_uint8_input_close_to_float(models):
    _, tmodel = models
    imgs = images(3)
    u8 = MaskRCNNResNet.from_config(tmodel.config, tmodel.params,
                                    uint8_input=True)
    x8, _, _ = u8.prepare(imgs)
    xf, _, _ = tmodel.prepare(imgs)
    mean = torch.tensor(tmodel.config.mean)
    for a, b in zip(x8, xf):
        assert a.dtype == torch.uint8
        np.testing.assert_allclose((a.float() - mean).numpy(), b.numpy(),
                                   rtol=0, atol=0.5 + 1e-3)
    out = u8.predict(imgs)
    assert len(out[0]) == len(imgs)


def run_python(code_or_args, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_import_leaves_jax_cv2_and_jax_package_out():
    res = run_python(["-c", (
        "import sys, json, mask_rcnn_tpu_torch\n"
        "from mask_rcnn_tpu_torch.models import api, mask_rcnn, heads\n"
        "from mask_rcnn_tpu_torch.ops import nms, roi_align, _kernels\n"
        "from mask_rcnn_tpu_torch.utils import checkpoint, masks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cv2', 'mask_rcnn_tpu')]\n"
        "print(json.dumps(bad))\n"
    )], REPO)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the smoke run would pass")
    res = run_python([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = run_python([str(lone)], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
