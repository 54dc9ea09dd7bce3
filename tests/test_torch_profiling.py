"""The port's profiling layer (``mask_rcnn_tpu_torch/utils/profiling.py``,
``ops/costs.py`` and the profiling tools) against the JAX package's on the
CPU: ``cost_of`` against XLA's ``cost_analysis()`` on the same seeded
inputs, the hand kernels' cost reports against ``chip_smoke.py``'s
conventions, the timing helpers' chains, the box helpers, and the four
tools' bodies at a tiny size."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mask_rcnn_tpu_torch.engine.trainer import TrainState
from mask_rcnn_tpu_torch.examples import _profile_common as common
from mask_rcnn_tpu_torch.examples import (
    bench_align_variants,
    head_profile,
    train_profile,
)
from mask_rcnn_tpu_torch.ops import boxes as port_boxes
from mask_rcnn_tpu_torch.ops import costs, nms, targets
from mask_rcnn_tpu_torch.utils import profiling

import chip_smoke
from tests.torch_profile_cases import one_thread, tool_kwargs

ra = importlib.import_module("mask_rcnn_tpu_torch.ops.roi_align")
resnet = importlib.import_module("mask_rcnn_tpu_torch.models.resnet")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca["flops"])


def _conv_jax(padding):
    def fn(x, w):
        return jax.nn.relu(jax.lax.conv_general_dilated(
            x, w, (1, 1), padding, dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC")))
    return fn


def _conv_torch(padding):
    def fn(x, w):
        return torch.relu(torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=padding))
    return fn


def _tail_jax(h, w1, b1, w2, b2):
    p5 = jnp.mean(h, axis=(1, 2))
    return p5 @ w1 + b1, p5 @ w2 + b2


def _tail_torch(h, w1, b1, w2, b2):
    p5 = h.mean(dim=(1, 2))
    return p5 @ w1 + b1, p5 @ w2 + b2


def _case(name, rng):
    """(jax fn, torch fn, inputs, XLA's elementwise flops that torch does
    not count, torch's padded-tap factor)."""
    f = np.float32
    if name == "conv1x1":
        x = rng.randn(8, 14, 14, 256).astype(f)
        w = rng.randn(1, 1, 256, 512).astype(f)
        # XLA counts the relu: one op an output
        return (_conv_jax("VALID"), _conv_torch(0), (x, w), 8 * 14 * 14 * 512,
                1.0)
    if name == "matmul":
        return (lambda a, b: a @ b, lambda a, b: a @ b,
                (rng.randn(64, 2048).astype(f),
                 rng.randn(2048, 324).astype(f)),
                0, 1.0)
    if name == "avgpool_linears":
        r = 16
        inputs = (rng.randn(r, 7, 7, 2048).astype(f),
                  rng.randn(2048, 324).astype(f), np.zeros(324, f),
                  rng.randn(2048, 81).astype(f), np.zeros(81, f))
        # the mean's adds over 7x7 and the bias adds
        return _tail_jax, _tail_torch, inputs, r * 49 * 2048 + r * 405, 1.0
    s = int(name.split("_")[-1])
    x = rng.randn(4, s, s, 512).astype(f)
    w = rng.randn(3, 3, 512, 512).astype(f)
    # XLA leaves out the taps on the zero border: per axis 3s - 2 of the 3s
    # (output, tap) pairs that torch counts
    return (_conv_jax("SAME"), _conv_torch(1), (x, w), 4 * s * s * 512,
            ((3 * s - 2) / (3 * s)) ** 2)


@pytest.mark.parametrize("name", ["conv1x1", "matmul", "avgpool_linears",
                                  "conv3x3_7", "conv3x3_14"])
def test_cost_of_flops_match_xla(name):
    """``cost_of``'s FLOPs against XLA's on the same seeded inputs, within
    2%: 1x1 convs, matmuls and the head's avgpool + linears tail after
    XLA's elementwise flops (which ``FlopCounterMode`` does not count); 3x3
    SAME convs after the analytic padded-tap ratio (torch counts the taps
    on the zero border, XLA does not: (19/21)^2 at 7x7, (40/42)^2 at
    14x14)."""
    jfn, tfn, inputs, elementwise, taps = _case(name, np.random.RandomState(0))
    want = xla_flops(jfn, *inputs)
    got, n_bytes = profiling.cost_of(tfn, *map(torch.from_numpy, inputs))
    assert n_bytes > 0
    assert abs(got * taps - (want - elementwise)) <= 0.02 * want, (got, want)
    if name in ("conv1x1", "matmul"):
        assert abs(got - want) <= 0.02 * want, (got, want)


def _rois(rng, n, r, h, w):
    y1 = rng.uniform(0, h * 0.7, (n, r))
    x1 = rng.uniform(0, w * 0.7, (n, r))
    return np.stack([y1, x1, y1 + rng.uniform(4, h * 0.3, (n, r)),
                     x1 + rng.uniform(4, w * 0.3, (n, r))], -1).astype(
        np.float32)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _align_samples_from_jax(rois, idx, fh, fw, c, p, s):
    """RoIAlign's bilinear samples for flat ``rois``, read off the grids
    that the JAX function's interpolation matrices use: P*P*grid_y*grid_x
    a roi."""
    jra = importlib.import_module("mask_rcnn_tpu.ops.roi_align")
    grids, interp = [], jra._interp_matrix
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jra, "_interp_matrix", lambda *a, **k: (
            grids.append(np.asarray(a[2])), interp(*a, **k))[1])
        jra.roi_align(jnp.zeros((2, fh, fw, c), jnp.float32),
                      jnp.asarray(rois.reshape(-1, 4).numpy()),
                      jnp.asarray(idx.numpy()), p, 1 / 16, bin_stride=s)
    gy, gx = grids
    return float((gy * gx).sum()) * p * p


def _pool_reads_from_jax(rois, idx, n, fh, fw, p):
    """Feature positions that max RoI pooling reads, from the JAX
    function's own bins: pooling 1 + y*W + x gives each bin's last row and
    column (+1), pooling its negation the first; an empty bin pools 0."""
    jra = importlib.import_module("mask_rcnn_tpu.ops.roi_align")
    pos = (1.0 + np.arange(fh * fw, dtype=np.float32)).reshape(1, fh, fw, 1)
    pos = jnp.asarray(np.repeat(pos, n, axis=0))
    args = (jnp.asarray(rois.numpy()), jnp.asarray(idx.numpy()), p, 1 / 16)
    with jax.disable_jit():
        last = np.asarray(jra.roi_pool(pos, *args))[..., 0].astype(int) - 1
        first = -np.asarray(jra.roi_pool(-pos, *args))[..., 0].astype(int) - 1
    rows = np.where(last >= 0, last // fw - first // fw + 1, 0)
    cols = np.where(last >= 0, last % fw - first % fw + 1, 0)
    return float((rows * cols).sum())


def _greedy_scan(boxes, valid, thresh, max_out):
    """A greedy NMS run row by row in numpy with the JAX suppression test
    (``inter > thresh * union``): (kept rows, IoU pairs), a pair for each
    row read against each box kept before it, until ``max_out`` are
    kept."""
    boxes = np.asarray(boxes, np.float32)
    kept, pairs = [], 0
    for j, box in enumerate(boxes):
        if max_out and len(kept) == max_out:
            break
        pairs += len(kept)
        if not valid[j]:
            continue
        ok = True
        for k in kept:
            ih = max(min(box[2], boxes[k, 2]) - max(box[0], boxes[k, 0]),
                     np.float32(0))
            iw = max(min(box[3], boxes[k, 3]) - max(box[1], boxes[k, 1]),
                     np.float32(0))
            inter = np.float32(ih * iw)
            area = [np.float32(max(b[2] - b[0], 0) * max(b[3] - b[1], 0))
                    for b in (box, boxes[k])]
            if inter > np.float32(thresh) * (area[0] + area[1] - inter):
                ok = False
        if ok:
            kept.append(j)
    return kept, pairs


def _decode_pairs(boxes, prob, valid, thresh, k, nms_thresh, d):
    """IoU pairs of the decode's selection: per (image, foreground class)
    the valid rows above ``thresh`` by falling score (ties by row), at
    most ``k``, scanned greedily to ``d`` kept."""
    pairs = 0
    for i in range(prob.shape[0]):
        for c in range(1, prob.shape[2]):
            p = prob[i, :, c].numpy()
            rows = [j for j in np.argsort(-p, kind="stable")
                    if valid[i, j] and p[j] > thresh][:k]
            pairs += _greedy_scan(boxes[i, rows, c].numpy(),
                                  np.ones(len(rows), bool), nms_thresh, d)[1]
    return pairs


def _kernel_case(name):
    """(call, expected (flops, bytes)) of a kernel wrapper on CPU tensors,
    by the kernel bounds' conventions: bytes each input once and each
    output once, FLOPs 8 a sample and channel (RoIAlign, crop-and-resize),
    12 an IoU pair, a compare a read (max RoI pooling), 2 a
    multiply-accumulate of the stem's conv. The counts come by routes of
    their own, not from ``ops/costs.py``: samples from the JAX function's
    grids, pooling reads from the JAX function's bins, IoU pairs from a
    greedy NMS in numpy."""
    rng = np.random.RandomState(1)
    nb = _nbytes
    n, fh, fw, c = 2, 6, 8, 16
    feats = torch.from_numpy(rng.randn(n, fh, fw, c).astype(np.float32))
    rois_g = torch.from_numpy(_rois(rng, n, 5, fh * 16, fw * 16))
    rois_f = rois_g.reshape(-1, 4).contiguous()
    idx = torch.arange(10, dtype=torch.int32) // 5
    samples = _align_samples_from_jax(rois_f, idx, fh, fw, c, 7, 2)
    if name == "roi_align_grouped":
        out = ra.roi_align_grouped(feats, rois_g, 7, 1 / 16, 0, 2)
        return (lambda: ra.roi_align_grouped(feats, rois_g, 7, 1 / 16, 0, 2),
                (8 * c * samples, nb(feats, rois_g, out)))
    if name == "roi_align_grouped_backward":
        g = torch.from_numpy(rng.randn(n, 5, 7, 7, c).astype(np.float32))
        args = (g, rois_g, (fh, fw), 1 / 16, 0, 2)
        return (lambda: ra.roi_align_grouped_backward(*args),
                (8 * c * samples,
                 nb(g, rois_g, ra.roi_align_grouped_backward(*args))))
    if name == "roi_align":
        args = (feats, rois_f, idx, 7, 1 / 16, 0, 2)
        return (lambda: ra.roi_align(*args),
                (8 * c * samples, nb(feats, rois_f, idx, ra.roi_align(*args))))
    if name == "roi_align_backward":
        g = torch.from_numpy(rng.randn(10, 7, 7, c).astype(np.float32))
        args = (g, rois_f, idx, (n, fh, fw), 1 / 16, 0, 2)
        return (lambda: ra.roi_align_backward(*args),
                (8 * c * samples,
                 nb(g, rois_f, idx, ra.roi_align_backward(*args))))
    if name in ("crop_and_resize", "roi_pool"):
        fn = getattr(ra, name)
        out = fn(feats, rois_f, idx, 14, 1 / 16)
        flops = (8 * out.numel() if name == "crop_and_resize"
                 else c * _pool_reads_from_jax(rois_f, idx, n, fh, fw, 14))
        return (lambda: fn(feats, rois_f, idx, 14, 1 / 16),
                (flops, nb(feats, rois_f, idx, out)))
    if name == "crop_and_resize_backward":
        g = torch.from_numpy(rng.randn(10, 14, 14, c).astype(np.float32))
        args = (g, rois_f, idx, (n, fh, fw), 1 / 16)
        return (lambda: ra.crop_and_resize_backward(*args),
                (8 * g.numel(),
                 nb(g, rois_f, idx, ra.crop_and_resize_backward(*args))))
    if name == "roi_pool_backward":
        g = torch.from_numpy(rng.randn(10, 14, 14, c).astype(np.float32))
        args = (g, feats, rois_f, idx, 1 / 16)
        return (lambda: ra.roi_pool_backward(*args),
                (2 * c * _pool_reads_from_jax(rois_f, idx, n, fh, fw, 14),
                 nb(g, feats, rois_f, idx, ra.roi_pool_backward(*args))))
    if name in ("nms_blocked", "nms_small"):
        b = torch.from_numpy(chip_smoke.proposal_like_boxes(rng, 300, 64,
                                                            96)[None])
        v = torch.from_numpy(rng.rand(1, 300) > 0.1)
        fn = getattr(nms, name)
        idx_out, mask = fn(b, v, 0.5, 40)
        kept, pairs = _greedy_scan(b[0], v[0].numpy(), 0.5, 40)
        assert idx_out[0][mask[0]].tolist() == kept
        return (lambda: fn(b, v, 0.5, 40),
                (12 * pairs, nb(b, v, idx_out, mask)))
    if name == "decode_select":
        rp, cls = 64, 5
        boxes = torch.from_numpy(np.stack(
            [chip_smoke.proposal_like_boxes(rng, rp, 64, 96)
             for _ in range(cls)], 1)[None])
        prob = torch.softmax(torch.from_numpy(
            rng.randn(1, rp, cls).astype(np.float32) * 2), -1)
        valid = torch.from_numpy(rng.rand(1, rp) > 0.1)
        args = (boxes.contiguous(), prob, valid, 0.05, 16, 0.5, 10)
        pairs = _decode_pairs(*args)
        return (lambda: nms.decode_select(*args),
                (12 * pairs, nb(*args[:3], *nms.decode_select(*args))))
    if name == "anchor_targets":
        anchors = torch.from_numpy(chip_smoke.proposal_like_boxes(
            rng, 120, 64, 96))
        bbox = torch.from_numpy(_rois(rng, n, 3, 64, 96))
        bv = torch.tensor([[True, True, False], [True, False, False]])
        pri = [torch.rand(n, 120, generator=torch.Generator().manual_seed(k))
               for k in (0, 1)]
        args = (bbox, bv, anchors, (64, 96), *pri,
                targets.AnchorTargetConfig())
        return (lambda: targets.anchor_targets(*args),
                (12 * 120 * 3, nb(bbox, bv, anchors, *pri,
                                  *targets.anchor_targets(*args))))
    if name == "proposal_targets":
        roi = torch.from_numpy(_rois(rng, n, 30, 64, 96))
        rv = torch.from_numpy(rng.rand(n, 30) > 0.1)
        bbox = torch.from_numpy(_rois(rng, n, 3, 64, 96))
        label = torch.from_numpy(rng.randint(0, 80, (n, 3)).astype(np.int32))
        bv = torch.tensor([[True, True, False], [True, True, True]])
        mask = torch.from_numpy((rng.rand(n, 3, 64, 96) > 0.5).astype(
            np.uint8))
        pri = [torch.rand(n, 33, generator=torch.Generator().manual_seed(k))
               for k in (0, 1)]
        cfg = targets.ProposalTargetConfig(n_sample=16)
        ins = (roi, rv, bbox, label, bv, mask, *pri)
        args = (*ins, cfg, (0.0,) * 4, (0.1, 0.1, 0.2, 0.2))
        out = targets.proposal_targets(*args)
        positives = int((out[2] > 0).sum())
        return (lambda: targets.proposal_targets(*args),
                (12 * 33 * 5 + 8 * positives * 14 * 14, nb(*ins, *out)))
    assert name == "stem_forward"
    x = torch.from_numpy(rng.randn(1, 30, 42, 3).astype(np.float32))
    params = {"conv1": {"W": torch.from_numpy(
        rng.randn(64, 3, 7, 7).astype(np.float32))},
        "bn1": {"scale": torch.ones(64), "bias": torch.zeros(64)}}
    out = resnet.stem_forward(params, x)
    return (lambda: resnet.stem_forward(params, x),
            (2 * 1 * 15 * 21 * 64 * 147,
             nb(x, params["conv1"]["W"], params["bn1"]["scale"],
                params["bn1"]["bias"], out)))


KERNELS = ("roi_align_grouped", "roi_align_grouped_backward", "roi_align",
           "roi_align_backward", "crop_and_resize", "crop_and_resize_backward",
           "roi_pool", "roi_pool_backward", "nms_blocked", "nms_small",
           "decode_select", "anchor_targets", "proposal_targets",
           "stem_forward")


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_report_follows_the_smoke_conventions(name):
    """Each hand kernel's wrapper reports one launch of the work
    ``chip_smoke.py`` bounds it by, counted here independently of
    ``ops/costs.py``; on CPU tensors the plain version that stands in for
    it adds nothing of its own to the count."""
    call, (flops, n_bytes) = _kernel_case(name)
    kernels = {}
    total = profiling.cost_of(call, kernels=kernels)
    assert kernels == {name: [flops, n_bytes, 1]}
    assert flops > 0 and n_bytes > 0
    assert total == (float(flops), float(n_bytes))


def test_reports_run_no_formula_without_a_counter(monkeypatch):
    """Outside ``cost_of`` a wrapper's report is one ``None`` check: its
    formula (which reads tensors, a host synchronisation on the card) never
    runs."""

    def boom(*args):
        raise AssertionError("a cost formula ran with no counter active")

    for fn in ("roi_align_grouped_cost", "roi_align_grouped_backward_cost",
               "nms_blocked_cost", "stem_forward_cost"):
        monkeypatch.setattr(costs, fn, boom)
    assert costs.ACTIVE is None
    for name in ("roi_align_grouped", "roi_align_grouped_backward",
                 "nms_blocked", "stem_forward"):
        _kernel_case(name)[0]()


def test_card_peaks_come_from_the_table():
    """The H100 gets its peaks; any other card none (MFU nan, never the
    H100's numbers)."""
    peaks = costs.CARDS.get("NVIDIA H100 80GB HBM3")
    assert peaks["flops"] == {"bf16": 989e12, "f32": 67e12}
    assert peaks["bytes_per_s"] == 3.35e12
    assert costs.CARDS.get("NVIDIA A100-SXM4-80GB") is None
    assert np.isnan(costs.roofline(1e12, 1e9, None)[0])
    row = {"flops": 1e12, "bytes": 1e9, "device_ms": 10.0}
    assert np.isnan(common.rates(row, None)[1])
    floor, bound = costs.roofline(1e12, 1e9, peaks, "f32")
    assert bound == "flop" and floor == pytest.approx(1e3 / 67)


def test_time_fn_chained_chains_build():
    """``build`` runs ``reps`` times a chain, warm-up chain included; each
    feed is the last one plus 0 times the last output's first value: the
    same values, and a NaN output poisons every later feed."""
    feeds = []

    def build(x):
        feeds.append(x)
        out = x * 2
        if len(feeds) == 3:
            out = out * float("nan")
        return out

    feed = torch.arange(4.0)
    ms = profiling.time_fn_chained(build, feed, reps=5, iters=2)
    assert ms > 0
    assert len(feeds) == 5 * 3
    assert all(torch.equal(f, feed) for f in feeds[:3])
    assert all(torch.isnan(f).all() for f in feeds[3:5])
    # each chain starts again from the feed
    assert torch.equal(feeds[5], feed)
    assert len({id(f) for f in feeds}) > 3


def test_time_train_steps_chained_carries_the_state():
    """``reps`` real consecutive steps a chain, the warm-up chain included:
    ``state.step`` advances by ``reps`` each, and each step sees the seed
    and the step count it would see in training."""
    seen = []

    def step(state, batch, seed):
        seen.append((state.step, seed))
        state.params["w"].add_(1.0)
        return TrainState(state.params, state.momentum, state.step + 1), {
            "loss": state.params["w"].sum()}

    state = TrainState({"w": torch.zeros(2)}, {}, 5)
    ms = profiling.time_train_steps_chained(step, state, {"image": None}, 7,
                                            reps=3, iters=2)
    assert ms > 0
    assert state.step == 5 + 3 * 3
    assert seen == [(5 + i, 7) for i in range(9)]
    assert torch.equal(state.params["w"], torch.full((2,), 9.0))


def _capture(runs=3, per_run=4, lose_device=(), lose_run=None,
             drop_mark=False):
    """Records of a synthetic capture as ``profiling._records`` gives them:
    a spare launch, then each run a host annotation holding ``per_run``
    launches (a kernel launch, then a copy) and one host callback, each
    launch's device activity 10 us long and 5 us after it; ``lose_device``
    drops those launches' device records (0 is the spare's), ``lose_run``
    a run's last launch and its device record."""
    records, corr, t = [(False, "cudaLaunchKernel", 0, -50, -40)], 0, 0
    if 0 not in lose_device:
        records.append((True, "spare", 0, -30, -20))
    for run in range(runs):
        if not (drop_mark and run == 0):
            records.append((False, profiling._RUN_MARK, 0, t,
                            t + 100_000))
        for i in range(per_run - (run == lose_run)):
            corr += 1
            name = "cudaLaunchKernel" if i % 2 == 0 else "cudaMemcpyAsync"
            records.append((False, name, corr, t + 1000 * i + 10,
                            t + 1000 * i + 20))
            if corr not in lose_device:
                records.append((True, f"kernel{i}", corr,
                                t + 1000 * i + 25, t + 1000 * i + 10_025))
        corr += 1
        records.append((False, "cudaLaunchHostFunc", corr, t + 90_000,
                        t + 90_010))
        t += 200_000
    return records


@pytest.mark.parametrize("case", ["whole", "a spare launch's record lost",
                                  "device records lost",
                                  "a run's records lost", "a run unmarked",
                                  "no launches"])
def test_device_busy_checks_the_capture(case):
    """``device_busy_ms`` reads a capture only when it holds every run
    launch's device activity and the same number of launches in each run;
    a capture that lost activities of its runs raises instead of reading
    low, and a lost spare launch outside the runs is only counted."""
    records = {
        "whole": _capture(),
        "a spare launch's record lost": _capture(lose_device=(0,)),
        "device records lost": _capture(lose_device=(2, 7, 8)),
        "a run's records lost": _capture(lose_run=1),
        "a run unmarked": _capture(drop_mark=True),
        "no launches": _capture(per_run=0),
    }[case]
    if case in ("whole", "a spare launch's record lost"):
        # four overlapping 10 us activities 1 us apart: 13 us a run
        assert profiling._checked_busy_ns(records, 3) == 3 * (3000 + 10_000)
        assert profiling.LAST_CAPTURE == {
            "launches": 12, "spare": 1, "spare_lost": int(case != "whole"),
            "orphans": 0}
        return
    with pytest.raises(RuntimeError, match="short profiler capture"):
        profiling._checked_busy_ns(records, 3)


def test_device_busy_reads_a_real_capture():
    """``_records`` reads a real profiler capture: each run's annotation is
    a host record (its span on the device timeline is no device work), and
    a capture without launches is refused as short."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(profiling._RUN_MARK):
                torch.ones(4) @ torch.ones(4)
    records = profiling._records(prof)
    marks = [r for r in records if r[1] == profiling._RUN_MARK]
    assert len(marks) == 2 and not any(r[0] for r in marks)
    with pytest.raises(RuntimeError, match="launches a run"):
        profiling._checked_busy_ns(records, 2)


def test_box_helpers_match_jax():
    from mask_rcnn_tpu.ops import boxes as jax_boxes

    rng = np.random.RandomState(2)
    b = _rois(rng, 3, 7, 480, 640)
    got = port_boxes.flip_boxes_horizontal(torch.from_numpy(b), 640.0)
    want = jax_boxes.flip_boxes_horizontal(jnp.asarray(b), 640.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = port_boxes.resize_boxes(torch.from_numpy(b), 1.25, 0.8)
    want = jax_boxes.resize_boxes(jnp.asarray(b), 1.25, 0.8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _reported(rows):
    common.check_rows(rows)
    return set().union(*(row["kernels"] for row in rows))


def test_bench_align_variants_tiny(capsys):
    """The RoIAlign shoot-out's ``main`` on the CPU at 4 rois an image:
    every route agrees with the flat one, every row finite."""
    assert bench_align_variants.main([
        "--rois-per-image", "4", "--height", "64", "--width", "96",
        "--iters", "1", "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("max|diff| vs flat K4 = 0.000e+00") == 4
    rows = bench_align_variants.run(r=4, height=64, width=96, iters=1,
                                    reps=1, device="cpu")
    assert len(rows) == 10
    assert _reported(rows) == {"roi_align", "roi_align_backward",
                               "roi_align_grouped",
                               "roi_align_grouped_backward"}


def test_head_profile_tiny():
    rows = head_profile.run(rois=8, iters=1, reps=1, device="cpu",
                            height=64, width=96)
    assert [r["name"] for r in rows][::2] == [
        "align flat fwd", "align grouped fwd", "res5 fwd",
        "mask branch fwd (2 rois)", "avgpool+linears fwd", "full head fwd"]
    assert _reported(rows) == {"roi_align", "roi_align_backward",
                               "roi_align_grouped",
                               "roi_align_grouped_backward"}
    by = {r["name"]: r for r in rows}
    assert by["res5 fwd+bwd"]["flops"] == pytest.approx(
        2 * by["res5 fwd"]["flops"])


def test_train_profile_tiny(capsys):
    """The per-stage profile of one 64x96 image, R-50, a few rois: the nine
    stages and the full step, finite, with every kernel of the step
    reporting."""
    rows = train_profile.run(dtype="float32", reps=1, **tool_kwargs())
    assert len(rows) == 10
    assert _reported(rows) == {"stem_forward", "nms_small",
                               "proposal_targets", "anchor_targets",
                               "roi_align_grouped",
                               "roi_align_grouped_backward"}
    by = {r["name"]: r for r in rows}
    assert by["fwd+bwd (autograd.grad)"]["flops"] == pytest.approx(
        by["full step (chained steps)"]["flops"])
    assert by["fwd loss (total)"]["flops"] < by[
        "fwd+bwd (autograd.grad)"]["flops"]
    out = capsys.readouterr().out
    assert "derived: bwd-only" in out and "unfused parts of the step" in out


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` leaves a Chrome/Perfetto trace of what ran inside it."""
    import json

    with profiling.trace(str(tmp_path / "tb")):
        profiling.sync(torch.ones(8) @ torch.ones(8))
    with open(tmp_path / "tb" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in str(ev.get("name", "")) or
               "dot" in str(ev.get("name", "")) for ev in events)
