"""Profiling and timing helpers, the port of
``mask_rcnn_tpu/utils/profiling.py``, on the device timeline.

* :func:`trace`: a ``torch.profiler`` capture written as a Chrome/Perfetto
  trace;
* :func:`sync`, :func:`time_fn`: ms per call as users feel it (CUDA events
  around back-to-back calls; the host clock on the CPU);
* :func:`time_fn_chained`, :func:`time_train_steps_chained`: device ms per
  call. The JAX helpers chain the calls inside one ``jax.jit`` to time the
  device without dispatch. Eager torch launches every op from the host and
  the port's steps are host-paced, so CUDA events around a chain would time
  the host. These helpers keep the chain (each call's output folded into
  the next feed) and read a ``torch.profiler`` capture of it instead: the
  union of the device activity intervals, over the calls, from a capture
  that is checked for lost activities;
* :func:`span`, :func:`setup_span`, :func:`first_call`: the port's own
  spans (``mrcnn.<what>``) around the host's work inside its calls, in a
  capture beside the device's activity and in :func:`spans`;
  :func:`count`, the hot path's counts beside them (:func:`counters`);
* :func:`cost_of`: (FLOPs, bytes) of a call, replacing XLA's
  ``cost_analysis()``: FLOPs from ``FlopCounterMode`` (torch's convention:
  a convolution counts its padded taps, which XLA leaves out), bytes from a
  dispatch mode that sums every aten op's operands and results (high, like
  XLA's "bytes accessed"), and the hand kernels' own reports
  (``ops/costs.py``), which no torch counter sees.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from mask_rcnn_tpu_torch.ops import costs


def _tensors(tree):
    """The tensor leaves of nested tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def _first_tensor(tree):
    return next(_tensors(tree), None)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace; on exit it is written to
    ``logdir/trace.json`` (Chrome's ``chrome://tracing`` and Perfetto read
    it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# Spans
#
# The port marks the host's work inside its calls with spans named
# ``mrcnn.<what>``: a served batch's ``mrcnn.submit`` (children
# ``mrcnn.prepare`` and ``mrcnn.predict_step``) and ``mrcnn.collect`` (child
# ``mrcnn.collect_wait``), ``predict_collect``'s ``mrcnn.paste``, a train
# step's ``mrcnn.train_step`` (children ``mrcnn.forward``,
# ``mrcnn.backward``, ``mrcnn.all_reduce`` and ``mrcnn.update``), and the
# set-up spans ``mrcnn.kernels_build`` or ``mrcnn.kernels_load`` and
# ``mrcnn.first_call``.
#
# Each span is recorded twice while a torch profiler runs: as a
# ``record_function`` annotation in the capture, beside the device's
# activity, and in the in-process list that :func:`spans` returns. Kineto
# stamps its host events on the Unix clock (``c10::getTime``), which
# ``time.time_ns()`` reads, so both records share one clock (a test holds
# each span to its annotation).
#
# Counts of what happened on the hot path, by name, are kept beside the
# spans, under the same rule: recorded only while a torch profiler runs,
# cleared with them. ``predict_collect_raw`` counts
# ``mrcnn.collect_overlapped``, a collect that returned while a later batch
# still ran on the device.


class Span(NamedTuple):
    """A closed span: stamps in ns on the profiler's clock, and the name of
    the span that was open around it on its thread (None at the top)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]


# The newest spans of the process, oldest first.
SPAN_LIMIT = 1 << 16
_SPANS = collections.deque(maxlen=SPAN_LIMIT)
_open = threading.local()
_COUNTS = collections.Counter()
_COUNTS_LOCK = threading.Lock()
# Padded input shapes each entry has run in this process.
_SEEN = set()
_OFF = contextlib.nullcontext()
# True while a torch profiler records this thread.
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "annotate", "mark", "start", "parent")

    def __init__(self, name: str, annotate: bool):
        self.name = name
        self.annotate = annotate

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.mark = record_function(self.name) if self.annotate else None
        self.start = time.time_ns()
        if self.mark is not None:
            self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mark is not None:
            self.mark.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _SPANS.append(Span(self.name, self.start, end, self.parent))
        return False


def span(name: str):
    """A span around work on the hot path (each served batch, each train
    step). While a torch profiler runs it enters ``record_function(name)``
    and records a :class:`Span`; otherwise it does nothing past the check
    that no profiler runs."""
    return _Span(name, True) if _profiling() else _OFF


def setup_span(name: str):
    """A span around work done once a process: always recorded in
    :func:`spans`, and annotated in the capture only while a profiler
    runs."""
    return _Span(name, _profiling())


def first_call(key):
    """``mrcnn.first_call`` (a :func:`setup_span`) around a call whose
    ``key``, the entry and the padded input batch's ``(n, H, W, dtype)``,
    this process has not run; nothing on later calls. The call launches
    its device work and returns: the device's share of a first call (the
    convolutions' algorithm search, the allocator's growth) lands in the
    wait that follows it, and the host's share is in this span."""
    if key in _SEEN:
        return _OFF
    _SEEN.add(key)
    return setup_span("mrcnn.first_call")


def count(name: str) -> None:
    """Count one ``name`` on the hot path while a torch profiler runs;
    otherwise do nothing past the check that no profiler runs."""
    if _profiling():
        with _COUNTS_LOCK:
            _COUNTS[name] += 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (the newest :data:`SPAN_LIMIT`)."""
    return list(_SPANS)


def counters() -> Dict[str, int]:
    """What :func:`count` recorded, by name."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_spans() -> None:
    """Clear the recorded spans and counts."""
    _SPANS.clear()
    with _COUNTS_LOCK:
        _COUNTS.clear()


def self_times_ns(name: str, records: Optional[List[Span]] = None
                  ) -> List[int]:
    """Each span named ``name`` (of ``records``, by default :func:`spans`)
    less the time its child spans cover, in ns, oldest first."""
    records = spans() if records is None else records
    children = sorted((s.start_ns, s.end_ns) for s in records
                      if s.parent == name)
    starts = [c[0] for c in children]
    out = []
    for s in records:
        if s.name != name:
            continue
        covered, end = 0, s.start_ns
        for lo, hi in children[bisect.bisect_left(starts, s.start_ns):]:
            if lo > s.end_ns:
                break
            hi = min(hi, s.end_ns)
            if hi > end:
                covered += hi - max(lo, end)
                end = hi
        out.append(s.end_ns - s.start_ns - covered)
    return out


def sync(tree) -> None:
    """Wait for the device of the first tensor leaf; nothing to wait for on
    the CPU."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def _on_cuda(*trees) -> bool:
    leaf = _first_tensor(trees)
    return leaf is not None and leaf.is_cuda


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call over ``iters`` back-to-back calls after
    ``warmup``: CUDA events on CUDA tensors (the host-paced time users
    feel), the host clock on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    if _on_cuda(out, args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters * 1000.0


# Host calls of the CUDA runtime and driver that each put one activity (a
# kernel, a copy or a memset) on the device; ``cudaLaunchHostFunc`` puts
# none there.
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cuMemcpy", "cuMemset")
_NO_DEVICE_ACTIVITY = ("cudaLaunchHostFunc",)
# The annotation around each run of :func:`device_busy_ms`.
_RUN_MARK = "profiling.device_busy_ms run"


def _records(prof):
    """(on the device?, name, correlation id, start ns, end ns) of every
    activity of a profiler capture but the annotations' spans on the
    device timeline, which are no device work (each annotation keeps its
    host record)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.device_type() == cuda, ev.name(), ev.correlation_id(),
             ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if not (ev.device_type() == cuda and ev.is_user_annotation())]


def _checked_busy_ns(records, runs: int) -> float:
    """The union of the device activity of the launches made inside
    ``runs`` identical runs, each in a :data:`_RUN_MARK` annotation;
    raises on a capture that lost activities of the runs.

    The profiler can lose device records without a sign: late in a long
    process on the H100's machine every capture lost 9 (1 kernel of 10,
    9 of 300 or of 9032). So every host launch in a run
    (:data:`_LAUNCHES`) must have its device activity, found by
    correlation id, and every run must show the same, nonzero, number of
    launches, which catches a run that lost host and device records
    together. :data:`LAST_CAPTURE` keeps what the capture lost outside
    the runs, where :func:`device_busy_ms` puts launches to spare."""
    device = {}
    for r in records:
        if r[0]:
            device.setdefault(r[2], []).append((r[3], r[4]))
    marks = sorted((r[3], r[4]) for r in records
                   if not r[0] and r[1] == _RUN_MARK)
    launches = sorted((r[3], r[1], r[2]) for r in records if not r[0]
                      and r[1].startswith(_LAUNCHES)
                      and not r[1].startswith(_NO_DEVICE_ACTIVITY))
    if len(marks) != runs:
        raise RuntimeError(f"short profiler capture: {len(marks)} of "
                           f"{runs} runs recorded on the host")
    inside = [any(lo <= t <= hi for lo, hi in marks) for t, _, _ in launches]
    ours = [x for x, keep in zip(launches, inside) if keep]
    spare = [x for x, keep in zip(launches, inside) if not keep]
    LAST_CAPTURE.update(
        launches=len(ours), spare=len(spare),
        spare_lost=sum(x[2] not in device for x in spare),
        orphans=len(set(device) - {x[2] for x in launches}))
    lost = [i for i, x in enumerate(ours) if x[2] not in device]
    if lost:
        raise RuntimeError(
            f"short profiler capture: {len(lost)} of {len(ours)} launches "
            f"have no device activity (at {lost[:12]}; "
            f"{sorted({ours[i][1] for i in lost})}; {LAST_CAPTURE})")
    per_run = [sum(lo <= x[0] <= hi for x in ours) for lo, hi in marks]
    if min(per_run) == 0 or len(set(per_run)) > 1:
        raise RuntimeError(f"short profiler capture: launches a run "
                           f"{per_run}, not one nonzero count")
    busy, end = 0, float("-inf")
    for lo, hi in sorted(span for x in ours for span in device[x[2]]):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


# What the last checked capture held: launches in its runs, launches to
# spare around them and how many of those lost their device activity, and
# device activities of no launch.
LAST_CAPTURE = {}
# Launches to spare before and after the runs of a capture: the profiler's
# losses seen on the H100's machine were 9 a capture.
_SPARE_LAUNCHES = 16


def _spare_launches():
    x = torch.zeros(1, device="cuda")
    for _ in range(_SPARE_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize()


def device_busy_ms(run, calls: int, runs: int = 1) -> float:
    """Device-busy ms per call: ``runs`` runs of ``run()``, ``calls``
    calls each, in one profiler capture; the union of the device activity
    of the runs' launches over ``runs * calls``. Raises if the capture
    holds no device work or lost any of the runs' (:func:`_checked_busy_ns`):
    each run must launch the same work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    # No acc_events: on the H100's machine (torch 2.11) the capture that
    # followed a chain captured with it kept one kernel in ten.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _spare_launches()
        for _ in range(runs):
            with record_function(_RUN_MARK):
                run()
                torch.cuda.synchronize()
        _spare_launches()
    busy = _checked_busy_ns(_records(prof), runs)
    if busy <= 0:
        raise RuntimeError("the profiler captured no device activity on "
                           "the card: no device time to report")
    return busy / 1e6 / (runs * calls)


def time_fn_chained(build: Callable, feed, reps: int = 50,
                    iters: int = 4) -> float:
    """Device milliseconds per call of ``build``: ``reps`` data-dependent
    calls a chain, ``iters`` chains after one warm-up chain.

    Each call's output is folded back into the feed at zero scale (its
    first leaf's first value times 0.0 is added to ``feed``), so every call
    depends on the one before and the values never change. On CUDA the
    chains run inside one ``torch.profiler`` capture and the result is the
    union of the device activity intervals over the ``iters * reps`` calls:
    the device's busy time without the host's dispatch gaps, what the JAX
    helper's jitted chain measures. It raises when the capture holds no
    device activity or lost some (:func:`device_busy_ms`: each chain must
    launch the same work). On the CPU it is the chains' host time per
    call.
    """

    def first_scalar(tree):
        leaf = _first_tensor(tree)
        return leaf.reshape(-1)[0].detach().float()

    def chain():
        x = feed
        for _ in range(reps):
            x = x + (0.0 * first_scalar(build(x))).to(x.dtype)
        return x

    sync(chain())
    if feed.is_cuda:
        return device_busy_ms(chain, reps, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = chain()
    sync(out)
    return (time.perf_counter() - t0) / iters / reps * 1000.0


def time_train_steps_chained(step, state, batch, seed: int, reps: int = 12,
                             iters: int = 3) -> float:
    """Steady-state milliseconds per train step: ``reps`` real consecutive
    steps of ``engine/trainer.py::make_train_step``'s ``step`` a chain,
    ``iters`` chains after one warm-up chain, one loss read at the end.

    The state is carried in place: its params and velocities are updated
    and ``state.step`` advances by ``reps`` a chain, warm-up included. The
    int ``seed`` stands for the JAX key folded at each step: the step seeds
    its sampling from ``(seed, state.step)``. On CUDA the result is the
    device-busy ms per step of a profiler capture of the timed chains (see
    :func:`time_fn_chained`); on the CPU the host time per step.
    """
    def chain():
        metrics = None
        for _ in range(reps):
            new, metrics = step(state, batch, seed)
            state.step = new.step
        return metrics["loss"]

    float(chain())
    if _on_cuda(batch):
        losses = []
        ms = device_busy_ms(lambda: losses.append(chain()), reps, iters)
        float(losses[-1])
        return ms
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = chain()
    float(loss)
    return (time.perf_counter() - t0) / iters / reps * 1000.0


# ---------------------------------------------------------------------------
# Costs


class _ByteMode(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results (views
    move nothing and are skipped) while not paused."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and not getattr(func, "is_view", False):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        return out


class _Counter:
    """The counter that :func:`cost_of` installs in ``ops.costs.ACTIVE``:
    ``FlopCounterMode`` and :class:`_ByteMode` for torch's ops, plus the
    hand kernels' reports. Work done while paused (a plain version standing
    in for its kernel, a formula) is left out."""

    def __init__(self):
        self.flop_mode = FlopCounterMode(display=False)
        self.byte_mode = _ByteMode()
        self.excluded_flops = 0
        self.kernels = {}  # name -> [flops, bytes, calls]
        self._depth = 0

    @contextlib.contextmanager
    def paused(self):
        if self._depth == 0:
            start = self.flop_mode.get_total_flops()
        self._depth += 1
        self.byte_mode.paused += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.byte_mode.paused -= 1
            if self._depth == 0:
                self.excluded_flops += (self.flop_mode.get_total_flops()
                                        - start)

    def add_kernel(self, name, cost, args):
        if self._depth:  # inside a plain version: not a launch
            return
        with self.paused():
            flops, n_bytes = cost(*args)
        entry = self.kernels.setdefault(name, [0, 0, 0])
        entry[0] += flops
        entry[1] += n_bytes
        entry[2] += 1

    @property
    def flops(self):
        return (self.flop_mode.get_total_flops() - self.excluded_flops
                + sum(e[0] for e in self.kernels.values()))

    @property
    def bytes(self):
        return self.byte_mode.bytes + sum(e[1] for e in self.kernels.values())


def cost_of(fn: Callable, *args, kernels=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call ``fn(*args)``, forward and whatever
    backward it runs.

    FLOPs are ``FlopCounterMode``'s (matmuls and convolutions; a
    convolution counts its padded border taps, which XLA's cost analysis
    leaves out, and elementwise ops count nothing) plus the hand kernels'
    reports; bytes sum every aten op's operands and results plus the
    kernels' inputs and outputs, an upper bound of the traffic like XLA's
    "bytes accessed". ``kernels``, a dict, receives {kernel: [flops, bytes,
    launches]} of the hand kernels' reports. The call runs once, for real.
    """
    counter = _Counter()
    previous, costs.ACTIVE = costs.ACTIVE, counter
    try:
        with counter.flop_mode, counter.byte_mode:
            sync(fn(*args))
    finally:
        costs.ACTIVE = previous
    if kernels is not None:
        kernels.update(counter.kernels)
    return float(counter.flops), float(counter.bytes)
