"""The port's detection decode (``models/mask_rcnn.py::decode``, whose
selection is ``ops/nms.py::decode_select``, the plain version on the CPU)
against the JAX package's ``_decode_single`` per image, on the edge cases
of ``torch_decode_cases.py``: labels, validity and the kept order exact,
boxes within 1e-4 and scores within 1e-6 (absolute)."""

import jax
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import mask_rcnn as jax_mrcnn
from mask_rcnn_tpu_torch.models import mask_rcnn
from mask_rcnn_tpu_torch.ops import nms
from tests.torch_decode_cases import DECODE_CASES, decode_case


def torch_decode(cfg_kw, inputs):
    cfg = mask_rcnn.MaskRCNNConfig(**cfg_kw)
    return mask_rcnn.decode(cfg, *(torch.from_numpy(a) for a in inputs))


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_matches_jax(name):
    cfg_kw, inputs = decode_case(name)
    jcfg = jax_mrcnn.MaskRCNNConfig(**cfg_kw)
    want = jax.vmap(
        lambda r, rv, cl, sc, sz, s: jax_mrcnn._decode_single(
            jcfg, r, rv, cl, sc, sz, s)
    )(*inputs)
    got = torch_decode(cfg_kw, inputs)
    want = [np.asarray(w) for w in want]
    assert want[3].any()
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-6)
    # scores come out in descending order, the padding after the detections
    s, v = got[2].numpy(), got[3].numpy()
    assert (np.diff(s, axis=1) <= 0).all()
    assert (v[:, :-1] >= v[:, 1:]).all()


def test_decode_case_kinds_reach_their_edges():
    """The cases exercise what they are named for: exact ties within and
    across classes, rounded-zero-area drops, and invalid rois."""
    cfg_kw, inputs = decode_case("ties")
    prob = torch.softmax(torch.from_numpy(inputs[3]), -1)
    assert torch.equal(prob[..., 1], prob[..., 2])  # across classes
    assert len(torch.unique(prob[0, :, 1])) < prob.shape[1] // 2  # within

    cfg_kw, inputs = decode_case("zero_area")
    cfg = mask_rcnn.MaskRCNNConfig(**cfg_kw)
    kept = torch_decode(dict(cfg_kw, detections_per_im=cfg.n_fg_class
                             * inputs[0].shape[1]), inputs)
    boxes = kept[0][kept[3]]
    roi = torch.from_numpy(inputs[0])
    thin = (roi[..., 2] - roi[..., 0] < 0.5).sum()
    assert thin > 0
    assert (torch.round(boxes[:, 2]) > torch.round(boxes[:, 0])).all()


@pytest.mark.parametrize("name", ["invalid_rois", "ties"])
def test_decode_topk_branches_agree(name):
    """k = 0 and k >= Rp (every row a class) and a k below Rp but above any
    class's count of candidates give the same detections bit for bit."""
    cfg_kw, inputs = decode_case(name)
    rp = inputs[0].shape[1]
    n_valid = int(inputs[1].sum(1).max())
    outs = [torch_decode(dict(cfg_kw, nms_topk_per_class=k), inputs)
            for k in (0, rp, rp + 7, n_valid)]
    assert n_valid < rp
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_decode_on_cpu_takes_the_plain_selection():
    """``decode`` on CPU tensors takes ``decode_select_plain``, and the
    wrapper does not count a launch there."""
    cfg_kw, inputs = decode_case("score_thresh_0")
    before = nms.decode_select.launches
    got = torch_decode(cfg_kw, inputs)
    assert nms.decode_select.launches == before
    assert got[3].sum() == 2 * cfg_kw["detections_per_im"]
