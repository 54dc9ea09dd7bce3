"""Collecting a served batch (``MaskRCNNResNet.predict_collect_raw``) waits
for that batch alone: handles collected out of order give what each batch
gives alone, bit for bit; the handle still unpacks as ``(out, sizes, n)``;
the hot path's counts (``utils/profiling.py::count``) follow the spans'
rule; and the benchmark's ``overlap_share.stream`` reads them.

On a card (marker ``cuda``; skips without one, imports no jax, so run it
there with ``python -m pytest tests/test_torch_collect.py --noconftest``):
a warm ``predict_submit`` makes no host-device sync, and a collect returns
while later work still runs on the device, counting
``mrcnn.collect_overlapped``."""

import collections
import os.path as osp
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mask_rcnn_tpu_torch.models import mask_rcnn, rpn
from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet, PredictHandle
from mask_rcnn_tpu_torch.utils import profiling
from port_bench import spec
from tests.torch_profile_cases import one_thread

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _model(device):
    cfg = mask_rcnn.MaskRCNNConfig(
        n_fg_class=3, n_layers=50, min_size=64, max_size=96,
        anchor_scales=(1.0, 2.0, 4.0), detections_per_im=8,
        proposal=rpn.ProposalConfig(n_test_pre_nms=96, n_test_post_nms=24))
    model = MaskRCNNResNet.from_config(
        cfg, mask_rcnn.init_params(cfg, torch.Generator().manual_seed(0),
                                   device), device=device)
    model.score_thresh = 0.0  # every valid detection reaches the arrays
    return model


def _batch(seed, n=2, h=48, w=72):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3, h, w) * 255).astype(np.float32) for _ in range(n)]


def assert_bitwise(got, want):
    """Two ``predict_collect_raw`` results: the same arrays, bit for bit,
    and the same sizes."""
    assert len(got) == len(want) == 5
    for g, w in zip(got[:4], want[:4]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    assert got[4] == want[4]


@pytest.fixture(scope="module")
def cpu_model():
    with one_thread():
        model = _model("cpu")
        model.predict_collect_raw(model.predict_submit(_batch(0)))
    return model


def test_interleaved_collects_equal_each_batch_alone(cpu_model):
    """Submit A, submit B, collect A, collect B: each as a submit and
    collect of its batch alone."""
    a, b = _batch(1), _batch(2, n=3)
    with one_thread():
        ha = cpu_model.predict_submit(a)
        hb = cpu_model.predict_submit(b)
        got_a = cpu_model.predict_collect_raw(ha)
        got_b = cpu_model.predict_collect_raw(hb)
        want_a = cpu_model.predict_collect_raw(cpu_model.predict_submit(a))
        want_b = cpu_model.predict_collect_raw(cpu_model.predict_submit(b))
    assert_bitwise(got_a, want_a)
    assert_bitwise(got_b, want_b)
    assert len(got_b[0]) == 3 and sum(len(x) for x in got_a[0]) > 0


def test_handle_unpacks_as_out_sizes_n(cpu_model):
    imgs = _batch(3, n=3, h=40, w=64)
    with one_thread():
        handle = cpu_model.predict_submit(imgs)
    assert isinstance(handle, PredictHandle)
    out, sizes, n = handle
    assert n == 3 and sizes == [(40, 64)] * 3
    assert set(out) == {"boxes", "labels", "scores", "valid", "mask_probs"}
    assert all(not v.is_cuda for v in out.values())
    assert handle.host is None and handle.ready is None


def test_count_records_only_under_a_profiler():
    profiling.reset_spans()
    profiling.count("mrcnn.collect_overlapped")
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("mrcnn.collect_overlapped")
        profiling.count("mrcnn.collect_overlapped")
        profiling.count("other")
    assert profiling.counters() == {"mrcnn.collect_overlapped": 2,
                                    "other": 1}
    profiling.reset_spans()
    assert profiling.counters() == {}


def _waits(k):
    S = profiling.Span
    return collections.deque(
        S("mrcnn.collect_wait", 10 * i, 10 * i + 5, "mrcnn.collect")
        for i in range(k))


@pytest.mark.parametrize("waits,overlapped,want", [
    (0, 0, None), (4, 0, 0.0), (4, 3, 75.0), (8, 8, 100.0)])
def test_overlap_share_reader(waits, overlapped, want, monkeypatch):
    with open(osp.join(REPO, "BENCHMARK.json")) as f:
        assert "overlap_share.stream" in f.read()
    read = spec.reader(types.SimpleNamespace(root=REPO),
                       "overlap_share.stream")
    monkeypatch.setattr(profiling, "_SPANS", _waits(waits))
    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter(
        {"mrcnn.collect_overlapped": overlapped} if overlapped else {}))
    assert read(None) == want


def test_overlap_share_reader_without_counts(monkeypatch):
    """A port that keeps spans but no counts, as before the counter: the
    reader gives None and does not raise."""
    read = spec.reader(types.SimpleNamespace(root=REPO),
                       "overlap_share.stream")
    monkeypatch.setattr(profiling, "_SPANS", _waits(4))
    monkeypatch.delattr(profiling, "counters")
    assert read(None) is None


# -- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _model("cuda")
    for imgs in (_batch(0), _batch(4, n=3)):  # the tests' padded shapes
        model.predict_collect_raw(model.predict_submit(imgs))
    torch.cuda.synchronize()
    return model


@pytest.mark.cuda
def test_warm_submit_makes_no_sync(card_model):
    """Nothing in a warm ``predict_submit`` waits on the device: a wait
    there would wait for the batch before it and undo the overlap."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [card_model.predict_submit(_batch(5)),
                   card_model.predict_submit(_batch(6, n=3))]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for handle in handles:
        out, _, _ = handle
        assert all(v.is_cuda for v in out.values())
        assert all(v.is_pinned() for v in handle.host.values())
        card_model.predict_collect_raw(handle)


@pytest.mark.cuda
def test_collect_returns_while_later_work_runs(card_model):
    """Submit A, a long device op, submit B, another long op; collecting A
    returns while B's event and the ops after it are still pending,
    counts ``mrcnn.collect_overlapped`` once, and gives what a blocking
    collect of A alone gives, in arrays that share no memory with the
    handle's copies."""
    a, b = _batch(7), _batch(8, n=3)
    cycles = 1_000_000_000  # ~0.5 s of the device at H100 clocks
    torch.cuda.synchronize()
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        ha = card_model.predict_submit(a)
        torch.cuda._sleep(cycles)
        hb = card_model.predict_submit(b)
        torch.cuda._sleep(cycles)
        after = torch.cuda.Event()
        after.record()
        got_a = card_model.predict_collect_raw(ha)
        pending = (hb.ready.query(), after.query())
        counts = profiling.counters()
        got_b = card_model.predict_collect_raw(hb)
    assert pending == (False, False)
    assert counts == {"mrcnn.collect_overlapped": 1}
    assert profiling.counters() == counts  # B was the newest when collected
    torch.cuda.synchronize()
    want_a = card_model.predict_collect_raw(card_model.predict_submit(a))
    want_b = card_model.predict_collect_raw(card_model.predict_submit(b))
    assert_bitwise(got_a, want_a)
    assert_bitwise(got_b, want_b)
    for part in got_a[:4]:
        for arr in part:
            for copy in ha.host.values():
                assert not np.shares_memory(arr, copy.numpy())
