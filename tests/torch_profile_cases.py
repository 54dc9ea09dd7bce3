"""Tiny inputs for the CPU runs of the port's profiling tools
(``tests/test_torch_profiling.py``, ``tests/test_torch_checks.py``): a
one-image 64x96 train batch with bit-packed masks, and proposal and
sampling settings cut to a few rois. Imports numpy, torch and the port
only."""

import contextlib

import numpy as np
import torch

from mask_rcnn_tpu_torch.data.synthetic import pack_mask_bits
from mask_rcnn_tpu_torch.models.rpn import ProposalConfig
from mask_rcnn_tpu_torch.models.targets import ProposalTargetConfig

TINY_PROPOSAL = ProposalConfig(n_train_pre_nms=200, n_train_post_nms=20,
                               n_test_pre_nms=200, n_test_post_nms=8)
TINY_SAMPLE = ProposalTargetConfig(n_sample=4)


def tiny_batch(n=1, h=64, w=96, g=2, seed=0):
    """A train batch of ``n`` images with ``g`` gt rectangles each."""
    rng = np.random.RandomState(seed)
    bbox = np.zeros((n, g, 4), np.float32)
    mask = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            y2 = y1 + rng.randint(16, h // 2)
            x2 = x1 + rng.randint(16, w // 2)
            bbox[i, k] = (y1, x1, y2, x2)
            mask[i, k, y1:y2, x1:x2] = 1
    return {
        "image": (rng.randn(n, h, w, 3) * 60).astype(np.float32),
        "bbox": bbox,
        "label": rng.randint(0, 80, (n, g)).astype(np.int32),
        "bbox_valid": np.ones((n, g), bool),
        "mask": pack_mask_bits(mask),
        "scale": np.full((n,), 1.0, np.float32),
    }


def tool_kwargs():
    """The tiny settings that ``train_profile.run`` and ``mfu_report.run``
    take (timing depth 1): 4 sampled rois an image, 8 proposals and 4
    detections an image when serving."""
    return dict(iters=1, device="cpu", batch=tiny_batch(),
                proposal_cfg=TINY_SAMPLE, proposal=TINY_PROPOSAL,
                detections_per_im=4)


@contextlib.contextmanager
def one_thread():
    """torch on one thread: the test workers share the machine's cores,
    and small ops on many threads each wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
