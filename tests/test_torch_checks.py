"""The port's last two checks (``check_eval_memory``,
``check_dtype_parity``) against the JAX scripts, and ``mfu_report``'s body,
on the CPU: the eval-memory classes give the JAX classes' mAP through the
evaluators on both scoring paths, the dtype-parity JSON is the JAX
script's on the same rehearsal summaries, and the MFU report runs at a
tiny size."""

import json
import os.path as osp
import runpy
import sys
import types

import numpy as np
import pytest

import mask_rcnn_tpu.engine.evaluator as jax_evaluator
from mask_rcnn_tpu_torch.engine import evaluator as port_evaluator
from mask_rcnn_tpu_torch.examples import _profile_common as common
from mask_rcnn_tpu_torch.examples import (
    check_dtype_parity,
    check_eval_memory,
    mfu_report,
)
from tests.torch_profile_cases import one_thread, tool_kwargs

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_EVAL_MEMORY = osp.join(REPO, "examples", "check_eval_memory.py")
JAX_DTYPE_PARITY = osp.join(REPO, "examples", "check_dtype_parity.py")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("raw", [False, True], ids=["paste", "raw"])
def test_eval_memory_map_matches_jax(raw):
    """6 synthetic images of 160x192 (the classes draw boxes of up to 120
    px), 10 detections each: the port's classes through the port's
    evaluator give the JAX classes' mAP through the JAX evaluator, on the
    paste path and on the raw (``add_boxlocal``) path."""
    jax_ns = runpy.run_path(JAX_EVAL_MEMORY)
    maps = []
    for ns, ev_mod in ((jax_ns, jax_evaluator),
                       (vars(check_eval_memory), port_evaluator)):
        ds = ns["SyntheticCOCOScaleDataset"](6, h=160, w=192)
        model = ns["FakeRawPredictModel" if raw else "FakePredictModel"](
            ds, 10)
        ev = ev_mod.InstanceSegmentationEvaluator(
            ds, [f"c{i}" for i in range(80)], kind="coco", batch_size=4)
        maps.append(ev(model)["validation/main/map"])
    assert np.isfinite(maps[0]) and maps[0] > 0
    assert maps[1] == maps[0]


@pytest.mark.parametrize("argv", [["--images", "2", "--dets", "5"],
                                  ["--images", "3", "--dets", "5", "--raw"]],
                         ids=["paste", "raw"])
def test_eval_memory_main(argv, capsys):
    assert check_eval_memory.main(argv) == 0
    out = capsys.readouterr().out
    assert "RSS BOUNDED: OK" in out and f"images={argv[1]}" in out


def _summary(dtype):
    return {"check": "coco_rehearsal",
            "map@0.5": {"float32": 0.61234567, "bfloat16": 0.60011}[dtype],
            "map": {"float32": 0.40123, "bfloat16": 0.41789}[dtype],
            "steps": 16, "log_dir": "logs/x"}


def _fake_run(calls):
    def run(cmd, **kw):
        calls.append(cmd)
        dtype = cmd[cmd.index("--compute-dtype") + 1]
        return types.SimpleNamespace(
            returncode=0, stdout="rehearsal log\n" + json.dumps(_summary(
                dtype)) + "\n")
    return run


def _flags(cmd):
    """{flag: value} of a rehearsal command line, without ``--device``."""
    start = next(i for i, a in enumerate(cmd) if a.startswith("--"))
    pairs = dict(zip(cmd[start::2], cmd[start + 1::2]))
    pairs.pop("--device", None)
    return pairs


def test_dtype_parity_json_matches_jax(monkeypatch, capsys, tmp_path):
    """With the rehearsal's subprocess stubbed by the same canned summaries,
    the port's ``check_dtype_parity`` runs the rehearsal with the JAX
    script's flags (plus ``--device``) and prints the JAX script's JSON."""
    flags = ["--min-size", "64", "--max-size", "96", "--max-epoch", "2",
             "--n-val", "4", "--min-map", "-1", "--workdir", str(tmp_path)]
    jax_calls, port_calls = [], []
    jax_ns = runpy.run_path(JAX_DTYPE_PARITY)
    monkeypatch.setattr(jax_ns["subprocess"], "run", _fake_run(jax_calls))
    monkeypatch.setattr(sys, "argv", ["check_dtype_parity.py"] + flags)
    jax_ns["main"]()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(check_dtype_parity.subprocess, "run",
                        _fake_run(port_calls))
    result = check_dtype_parity.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert json.loads(got) == result
    assert [_flags(c) for c in port_calls] == [_flags(c) for c in jax_calls]
    assert all(c[1:3] == ["-m",
                          "mask_rcnn_tpu_torch.examples.check_coco_rehearsal"]
               and c[c.index("--device") + 1] == "cpu" for c in port_calls)


def test_mfu_report_tiny(capsys):
    """The MFU report on one 64x96 image, R-50, a few rois, both dtypes:
    inference, forward loss and the train step, finite, with the kernels of
    each path reporting their work."""
    rows = mfu_report.run(reps=1, step_reps=1, **tool_kwargs())
    common.check_rows(rows)
    assert [r["name"] for r in rows] == [
        f"{what} {dtype}" for dtype in ("float32", "bfloat16")
        for what in ("infer b1", "train fwd-loss b1", "train step b1")]
    assert set(rows[0]["kernels"]) == {"stem_forward", "nms_small",
                                       "roi_align_grouped", "decode_select"}
    assert set(rows[2]["kernels"]) == {"stem_forward", "nms_small",
                                       "roi_align_grouped",
                                       "roi_align_grouped_backward",
                                       "proposal_targets", "anchor_targets"}
    out = capsys.readouterr().out
    assert "MFU against the bf16 peak for both dtypes" in out
