"""The traffic is the same for the same seed, differs for another, and
every seed gets the same sizes and arrival gaps in another order."""

import numpy as np
import torch

from port_bench import traffic
from port_bench.tests import tiny

SEED = 2 ** 33 + 5  # beyond 32 bits: the command takes any whole seed


def _sizes(batches):
    return [[im.shape for im in b] for b in batches]


def test_serve_batches_follow_the_seed():
    t = tiny.TRAFFIC["tiny-stream"]
    a = traffic.serve_batches(t, SEED, "cpu")
    b = traffic.serve_batches(t, SEED, "cpu")
    c = traffic.serve_batches(t, SEED + 1, "cpu")
    assert _sizes(a) == _sizes(b)
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    assert sum(float(x.sum()) for p in a for x in p) != \
        sum(float(x.sum()) for p in c for x in p)
    # the same multiset of sizes in another order
    flat = sorted(s for b in _sizes(a) for s in b)
    assert flat == sorted(s for b in _sizes(c) for s in b)


def test_arrivals_are_the_traffics_own():
    t = dict(tiny.TRAFFIC["tiny-online"], rate=40.0)
    a = traffic.arrivals(t, 10)
    assert a == traffic.arrivals(t, 10)
    c = traffic.arrivals(dict(t, arrival_seed=2), 10)
    assert a != c
    gaps = sorted(np.diff(a).round(9))
    assert len(a) == len(c) == 401
    assert abs(a[-1] - c[-1]) < 0.2  # nearly the same total
    assert abs(np.mean(np.diff(a)) - 1 / 40) < 2e-3
    assert gaps[0] > 0


def test_train_batches_follow_the_seed():
    t, m = tiny.TRAFFIC["tiny-train"], tiny.MODEL
    a = traffic.train_batches(t, m, SEED, "cpu")
    b = traffic.train_batches(t, m, SEED, "cpu")
    c = traffic.train_batches(t, m, SEED + 1, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert any(not torch.equal(x["image"], y["image"])
               for x, y in zip(a, c) if x["image"].shape == y["image"].shape)
    counts = sorted(int(v) for x in a for v in x["bbox_valid"].sum(1))
    assert counts == sorted(int(v) for x in c for v in x["bbox_valid"].sum(1))
    for x in a:
        # one orientation a batch; every box inside its mask's image
        assert x["image"].shape[1] != x["image"].shape[2]
        valid = x["bbox_valid"]
        assert (x["mask"].sum((2, 3))[valid] > 0).all()
        assert (x["bbox"][valid][:, 2:] > x["bbox"][valid][:, :2]).all()


def test_priorities_follow_the_step():
    p1 = traffic.priorities({}, SEED, 1, 2, 50, 10, "cpu")
    p1b = traffic.priorities({}, SEED, 1, 2, 50, 10, "cpu")
    p2 = traffic.priorities({}, SEED, 2, 2, 50, 10, "cpu")
    assert torch.equal(p1["anchor"][0], p1b["anchor"][0])
    assert not torch.equal(p1["anchor"][0], p2["anchor"][0])
    # the proposals' priorities keep the candidates' own order
    assert (torch.diff(p1["proposal"][0], dim=1) < 0).all()
