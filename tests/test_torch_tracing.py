"""The port's own spans (``mask_rcnn_tpu_torch/utils/profiling.py``) on the
CPU, at a tiny size: nothing recorded or annotated on the hot path while no
profiler runs; under a profiler the span tree of a served batch and of a
train step, each span on its ``record_function`` record's clock; one
``mrcnn.first_call`` a padded shape; the kernels' build or load; and the
benchmark's readers of the spans."""

import collections
import os.path as osp
import types

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from mask_rcnn_tpu_torch.data.loader import pack_mask_bits
from mask_rcnn_tpu_torch.engine import trainer
from mask_rcnn_tpu_torch.models import mask_rcnn, rpn, targets
from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet
from mask_rcnn_tpu_torch.ops import _kernels
from mask_rcnn_tpu_torch.parallel.mesh import DataParallel
from mask_rcnn_tpu_torch.utils import profiling
from port_bench import spec
from tests.torch_profile_cases import one_thread

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

HOT = {"mrcnn.submit", "mrcnn.prepare", "mrcnn.predict_step",
       "mrcnn.collect", "mrcnn.collect_wait", "mrcnn.paste",
       "mrcnn.train_step", "mrcnn.forward", "mrcnn.backward",
       "mrcnn.all_reduce", "mrcnn.update"}
# (span, parent) of a warm served batch, its pasted collect, and a
# data-parallel train step
TREE = {("mrcnn.submit", None), ("mrcnn.prepare", "mrcnn.submit"),
        ("mrcnn.predict_step", "mrcnn.submit"), ("mrcnn.collect", None),
        ("mrcnn.collect_wait", "mrcnn.collect"), ("mrcnn.paste", None),
        ("mrcnn.train_step", None), ("mrcnn.forward", "mrcnn.train_step"),
        ("mrcnn.backward", "mrcnn.train_step"),
        ("mrcnn.all_reduce", "mrcnn.train_step"),
        ("mrcnn.update", "mrcnn.train_step")}


class Solo(DataParallel):
    """One rank of a data-parallel batch of one, with no process group."""

    def __init__(self):
        super().__init__(0, 1)

    def all_reduce(self, t):
        return t

    def all_reduce_grads(self, grads):
        return list(grads)


def _config():
    return mask_rcnn.MaskRCNNConfig(
        n_fg_class=3, n_layers=50, min_size=64, max_size=96,
        anchor_scales=(1.0, 2.0, 4.0), detections_per_im=8,
        proposal=rpn.ProposalConfig(n_train_pre_nms=96, n_train_post_nms=24,
                                    n_test_pre_nms=96, n_test_post_nms=24))


def _images(n, h=48, w=72):
    rng = np.random.RandomState(n)
    return [(rng.rand(3, h, w) * 255).astype(np.float32) for _ in range(n)]


def _train_batch(n=2, h=64, w=96, g=3):
    rng = np.random.RandomState(11)
    bbox = np.zeros((n, g, 4), np.float32)
    masks = np.zeros((n, g, h, w), np.uint8)
    for i in range(n):
        for k in range(g):
            y1, x1 = rng.uniform(2, h - 30), rng.uniform(2, w - 30)
            y2, x2 = y1 + rng.uniform(12, 25), x1 + rng.uniform(12, 25)
            bbox[i, k] = (y1, x1, y2, x2)
            masks[i, k, int(y1):int(y2), int(x1):int(x2)] = 1
    batch = {"image": (rng.randn(n, h, w, 3) * 20).astype(np.float32),
             "bbox": bbox, "label": rng.randint(0, 3, (n, g)).astype(np.int32),
             "bbox_valid": np.ones((n, g), bool),
             "mask": pack_mask_bits(masks),
             "scale": np.ones((n,), np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def port():
    with one_thread():
        cfg = _config()
        model = MaskRCNNResNet.from_config(
            cfg, mask_rcnn.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu"), device="cpu")
        params = mask_rcnn.init_params(cfg, torch.Generator().manual_seed(1),
                                       "cpu")
        opt, _ = trainer.make_optimizer(params, 0.005, 100)
        step_fn = trainer.make_train_step(
            cfg, opt, proposal_cfg=targets.ProposalTargetConfig(n_sample=16),
            anchor_cfg=targets.AnchorTargetConfig(n_sample=32))
        state = trainer.create_train_state(params, opt)
        batch = _train_batch()
        # the shapes' first calls, so that what follows is the hot path
        model.predict(_images(2))
        state, _ = step_fn(state, batch, 0, data_parallel=Solo())
    return types.SimpleNamespace(model=model, step_fn=step_fn, state=state,
                                 batch=batch)


def _serve_and_step(port):
    handle = port.model.predict_submit(_images(2))
    port.model.predict_collect_raw(handle)
    port.model.predict(_images(2))
    port.state, _ = port.step_fn(port.state, port.batch, 1,
                                 data_parallel=Solo())


def _capture(port):
    """The spans and the capture's ``mrcnn.`` records of one served batch,
    one pasted batch and one train step under a CPU profiler."""
    profiling.reset_spans()
    with one_thread(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("capture"):
            _serve_and_step(port)
    records = [(ev.name(), ev.start_ns(), ev.end_ns())
               for ev in prof.profiler.kineto_results.events()
               if ev.name().startswith("mrcnn.")]
    return profiling.spans(), sorted(records, key=lambda r: r[1])


@pytest.fixture(scope="module")
def captured(port):
    with one_thread():
        # The first capture of a process, and the first annotation of a
        # capture on a thread, set up the profiler's buffers (~0.1 ms on a
        # CPU runner) between a span's stamp and kineto's: the spans are
        # held to a second capture, which enters a mark first, as the
        # benchmark's capture does.
        with profile(activities=[ProfilerActivity.CPU]):
            _serve_and_step(port)
        return _capture(port)


def test_no_profiler_records_no_hot_span_and_annotates_nothing(
        port, monkeypatch):
    def refuse(self):
        raise AssertionError(f"record_function({self.name!r}) entered")

    monkeypatch.setattr(record_function, "__enter__", refuse)
    profiling.reset_spans()
    with one_thread():
        _serve_and_step(port)
    assert not [s for s in profiling.spans() if s.name in HOT]


def test_profiler_records_the_span_tree(captured):
    recorded, _ = captured
    assert {(s.name, s.parent) for s in recorded} == TREE
    # two batches served, the second pasted; one step
    twice = {"mrcnn.submit", "mrcnn.prepare", "mrcnn.predict_step",
             "mrcnn.collect", "mrcnn.collect_wait"}
    assert collections.Counter(s.name for s in recorded) == {
        name: 2 if name in twice else 1 for name, _ in TREE}
    for parent in recorded:
        kids = [s for s in recorded if s.parent == parent.name
                and parent.start_ns <= s.start_ns <= parent.end_ns]
        for s in kids:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert sum(s.end_ns - s.start_ns for s in kids) <= \
            parent.end_ns - parent.start_ns


def test_spans_lie_on_their_records_clock(port, captured):
    """Each span's start and end within 100 us of its own
    ``record_function`` record in the capture's ``kineto_results``. Up to
    three captures: the OS may preempt the process between a span's stamp
    and kineto's, which no clock can help, while an offset between the
    two clocks fails every capture."""
    worst = []
    for attempt in range(3):
        recorded, records = captured if attempt == 0 else _capture(port)
        assert recorded
        ordered = sorted(recorded, key=lambda s: s.start_ns)
        assert [s.name for s in ordered] == [r[0] for r in records]
        worst.append(max(max(abs(s.start_ns - start), abs(s.end_ns - end))
                         for s, (_, start, end) in zip(ordered, records)))
        if worst[-1] < 100_000:
            return
    pytest.fail(f"the largest lag of each capture, ns: {worst}")


def test_first_call_once_a_padded_shape(port, monkeypatch):
    monkeypatch.setattr(profiling, "_SEEN", set())

    def first_calls():
        return sum(s.name == "mrcnn.first_call" for s in profiling.spans())

    with one_thread():
        profiling.reset_spans()
        port.model.predict(_images(2))
        assert first_calls() == 1
        port.model.predict(_images(2))
        assert first_calls() == 1
        port.model.predict(_images(1))  # another batch size: a new shape
        port.state, _ = port.step_fn(port.state, port.batch, 2)
        assert first_calls() == 3
        port.state, _ = port.step_fn(port.state, port.batch, 3)
        port.model.predict(_images(1))
        assert first_calls() == 3
    first = [s for s in profiling.spans() if s.name == "mrcnn.first_call"]
    assert all(s.parent is None for s in first)


@pytest.mark.parametrize("exists", [True, False])
def test_kernels_span_names_a_load_or_a_build(exists, monkeypatch,
                                              tmp_path):
    """The first ``lib()`` of a process sits in ``mrcnn.kernels_load`` when
    the library of the sources' hash is there, else in
    ``mrcnn.kernels_build``."""
    so = tmp_path / "libmrcnn_kernels_0.so"
    if exists:
        so.write_bytes(b"")
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace()
                                    for name in _kernels._SIGNATURES})
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "library", lambda: so)
    monkeypatch.setattr(_kernels, "build", lambda: so)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: fake)
    profiling.reset_spans()
    assert _kernels.lib() is fake and _kernels.lib() is fake
    want = "mrcnn.kernels_load" if exists else "mrcnn.kernels_build"
    assert [s.name for s in profiling.spans()] == [want]


def test_self_times_leave_out_the_children():
    S = profiling.Span
    records = [S("mrcnn.first_call", 0, 100, None),
               S("mrcnn.kernels_load", 10, 30, "mrcnn.first_call"),
               S("mrcnn.first_call", 200, 250, None),
               S("mrcnn.submit", 205, 240, "mrcnn.first_call"),
               S("mrcnn.prepare", 206, 220, "mrcnn.submit")]
    assert profiling.self_times_ns("mrcnn.first_call", records) == [80, 15]
    assert profiling.self_times_ns("mrcnn.submit", records) == [21]
    assert profiling.self_times_ns("mrcnn.paste", records) == []


# (reader, what it reads from ``SPANS``)
READS = {"prepare_ms.stream": 2.0, "launch_ms.stream": 30.0,
         "collect_wait_ms.stream": 0.5, "forward_ms.train": 20.0,
         "backward_ms.train": 22.0, "update_ms.train": 1.0,
         "first_call_s": 1.5, "kernels_s": 0.25}


def _span_list():
    S, ms = profiling.Span, 1_000_000
    out = [S("mrcnn.first_call", 0, 1750 * ms, None),
           S("mrcnn.kernels_load", 0, 250 * ms, "mrcnn.first_call")]
    t = 2000 * ms
    for wide in (0.5, 1.0, 1.5):  # three batches and steps, median 1.0
        for name, dur, parent in (
                ("mrcnn.prepare", 2 * wide, "mrcnn.submit"),
                ("mrcnn.predict_step", 30 * wide, "mrcnn.submit"),
                ("mrcnn.collect_wait", 0.5 * wide, "mrcnn.collect"),
                ("mrcnn.forward", 20 * wide, "mrcnn.train_step"),
                ("mrcnn.backward", 22 * wide, "mrcnn.train_step"),
                ("mrcnn.update", 1 * wide, "mrcnn.train_step")):
            out.append(S(name, t, t + int(dur * ms), parent))
            t += 100 * ms
    return out


@pytest.mark.parametrize("metric", sorted(READS))
def test_span_readers(metric, monkeypatch):
    with open(osp.join(REPO, "BENCHMARK.json")) as f:
        assert metric in f.read()
    read = spec.reader(types.SimpleNamespace(root=REPO), metric)
    monkeypatch.setattr(profiling, "_SPANS", collections.deque())
    assert read(None) is None
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(_span_list()))
    assert read(None) == pytest.approx(READS[metric])
