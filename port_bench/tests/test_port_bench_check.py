"""``correct`` comes out true for the program as it is and false with each
fault a cell can have planted under the timed path, and false for the
control (the reference on float8 operands in the program's place). On the
CPU at a tiny size (float32 on both sides, so the tiny limits are tight);
the control at the cells' own sizes against their real limits runs on the
card (``cuda``)."""

import time

import pytest
import torch

from port_bench import calibrate, check, harness, spec
from port_bench.tests import tiny

SEED = 2 ** 34 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(root, cell):
    run = harness.Run(spec.load(cell, root), SEED, 3.0, False, "cpu",
                      time.perf_counter())
    return harness.execute(run)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_program_is_correct(root, cell):
    res = _correct(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,kind", [
    ("tiny.stream", "half"), ("tiny.stream", "alter"),
    ("tiny.online", "alter"), ("tiny.train", "half"),
    ("tiny.train", "unchanged")])
def test_a_planted_fault_is_not_correct(root, cell, kind):
    with calibrate.fault(kind, spec.load(cell, root).mode):
        res = _correct(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_is_not_correct(root, cell):
    c = spec.load(cell, root)
    control = (calibrate.train_control if c.mode == "train"
               else calibrate.serve_control)
    ok, rows = check.verdict(control(c, SEED, "cpu"), c.limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r50c4-coco-stream-b4",
                                  "r101c4-coco-train-b4",
                                  "r50c4-coco-train-b4",
                                  "r50c4-coco-online"])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    c = spec.load(cell)
    control = (calibrate.train_control if c.mode == "train"
               else calibrate.serve_control)
    for seed in (11, 12, 13):
        ok, rows = check.verdict(control(c, seed, "cuda:0"), c.limits)
        assert not ok, rows
