"""Synthetic-COCO dress rehearsal of the port's whole COCO driver surface,
the port of ``examples/check_coco_rehearsal.py``.

Writes an on-disk COCO_ROOT (``data/synthetic.py``: PNG images and
instances_*.json with polygon, RLE and crowd annotations), then runs the
user journey through the port's own drivers, each in its own process:

    COCO_ROOT=... python -m mask_rcnn_tpu_torch.examples.coco.train
    python -m mask_rcnn_tpu_torch.examples.coco.evaluate logs/<ts>
    python -m mask_rcnn_tpu_torch.examples.coco.demo logs/<ts> --images ...
    python -m mask_rcnn_tpu_torch.examples.summarize_logs logs/

and checks the logs/<ts>/ artifact contract (params.yaml, JSON log,
snapshot_model.npz, eval_result.yaml, visualizations), the demo's output,
the summary table and, unless ``--min-map -1``, a mAP@0.5 bar. The last
line printed is a JSON summary.

On the card (the drivers' defaults: min 800 / max 1333):
    python -m mask_rcnn_tpu_torch.examples.check_coco_rehearsal \\
        --max-epoch 250
Tiny CPU run (same flow, small shapes):
    python -m mask_rcnn_tpu_torch.examples.check_coco_rehearsal \\
        --min-size 64 --max-size 96 --max-epoch 2 --min-map -1 --device cpu
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
PKG = "mask_rcnn_tpu_torch.examples"


def run(module, args, env=None):
    """``python -m <PKG>.<module> <args>`` from the repo root; its output
    (the last 6000 characters are echoed); a failure exits."""
    cmd = [sys.executable, "-m", f"{PKG}.{module}"] + [str(a) for a in args]
    print(f"$ {' '.join(cmd)}", flush=True)
    res = subprocess.run(
        cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    print(res.stdout[-6000:], flush=True)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {cmd}")
    return res.stdout


def add_common_args(parser, max_epoch, hw, min_max):
    parser.add_argument("--workdir", default=None,
                        help="default: a fresh temp dir")
    parser.add_argument("--max-epoch", type=float, default=max_epoch)
    parser.add_argument("--min-size", type=int, default=None,
                        help="override driver resize (default: the "
                        f"unmodified {min_max} configuration)")
    parser.add_argument("--max-size", type=int, default=None)
    parser.add_argument("--image-hw", type=int, nargs=2, default=None,
                        help=f"synthetic image size (default: {hw}, or "
                        "96 128 when --min-size is overridden)")
    parser.add_argument("--compute-dtype", default=None,
                        choices=("float32", "bfloat16"))
    parser.add_argument("--eval-interval-epochs", type=float, default=None,
                        help="default: max_epoch/8, so the run spends its "
                        "time training rather than re-evaluating the tiny "
                        "val split every epoch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-val", type=int, default=4,
                        help="synthetic validation split size")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every driver ('cpu' runs "
                        "every kernel's plain version)")


def journey(args, dataset, env, logs_dir, val_img, demo_out, map_key):
    """Train, check the artifacts, evaluate, demo and summarize; returns
    (log dir, the log's entries, the eval result)."""
    from mask_rcnn_tpu_torch.utils.logging import load_params_yaml, load_yaml

    train_args = [
        "--logs-dir", logs_dir,
        "--max-epoch", args.max_epoch,
        "--seed", args.seed,
        "--eval-interval-epochs",
        (args.eval_interval_epochs if args.eval_interval_epochs is not None
         else max(args.max_epoch / 8, 1.0)),
        "--device", args.device,
    ]
    if args.min_size:
        train_args += ["--min-size", args.min_size]
    if args.max_size:
        train_args += ["--max-size", args.max_size]
    if args.compute_dtype:
        train_args += ["--compute-dtype", args.compute_dtype]
    run(f"{dataset}.train", train_args, env=env)

    # A reused --workdir accumulates one logs/<ts> dir per run; validate
    # the newest.
    run_dirs = [d for d in sorted(glob.glob(osp.join(logs_dir, "*")))
                if osp.isdir(d)]
    assert run_dirs, f"train wrote no run dir under {logs_dir}"
    log_dir = run_dirs[-1]

    # -- artifact contract after train ------------------------------------
    for name in ("params.yaml", "log", "snapshot_model.npz"):
        assert osp.exists(osp.join(log_dir, name)), f"missing {name}"
    vis = glob.glob(osp.join(log_dir, "visualizations", "*.jpg"))
    assert vis, "train wrote no visualization tiles"
    with open(osp.join(log_dir, "log")) as f:
        entries = json.load(f)
    losses = [e["main/loss"] for e in entries if "main/loss" in e]
    assert losses and np.isfinite(losses).all(), "no finite losses"
    params_yaml = load_params_yaml(log_dir)
    assert params_yaml["dataset"] == dataset
    assert "git_hash" in params_yaml and "model_config" in params_yaml

    # -- evaluate on the same log dir -------------------------------------
    run(f"{dataset}.evaluate", [log_dir, "--device", args.device], env=env)
    eval_path = osp.join(log_dir, "snapshot_model.npz.eval_result.yaml")
    assert osp.exists(eval_path), "evaluate wrote no eval_result.yaml"
    eval_result = load_yaml(eval_path)
    map50 = eval_result.get(map_key, float("nan"))
    print(f"rehearsal {map_key} = {map50}")
    if args.min_map >= 0:
        assert map50 >= args.min_map, (
            f"{map_key} {map50} < required {args.min_map}"
        )

    # -- the demo on a val image ------------------------------------------
    run(f"{dataset}.demo", [log_dir, "--images", val_img, "--score-thresh",
                            "0.3", "--out", demo_out, "--device",
                            args.device], env=env)
    assert glob.glob(osp.join(demo_out, "*" + osp.splitext(val_img)[1])), \
        "demo saved no output"

    # -- summarize_logs over the logs dir ---------------------------------
    table = run("summarize_logs", [logs_dir], env=env)
    assert osp.basename(log_dir) in table
    assert "eval_map" in table
    return log_dir, entries, eval_result


def main(argv=None):
    """Returns the summary (also printed as the last line)."""
    parser = argparse.ArgumentParser()
    add_common_args(parser, 250.0, "480 640", "800/1333 COCO")
    parser.add_argument("--n-train", type=int, default=8,
                        help="synthetic train split size")
    parser.add_argument("--min-map", type=float, default=0.5,
                        help="required validation/main/map@0.5 from the "
                        "evaluate step (-1 disables the bar for smoke "
                        "runs)")
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.data.synthetic import make_synthetic_coco_root

    workdir = args.workdir or tempfile.mkdtemp(prefix="coco_rehearsal_")
    os.makedirs(workdir, exist_ok=True)
    hw = args.image_hw or ((96, 128) if args.min_size else (480, 640))
    coco_root = make_synthetic_coco_root(
        osp.join(workdir, "COCO"), height=hw[0], width=hw[1],
        n_train=args.n_train, n_minival=args.n_val, seed=args.seed,
    )
    val_img = sorted(glob.glob(osp.join(coco_root, "val2014", "*.png")))[0]
    log_dir, entries, eval_result = journey(
        args, "coco", dict(os.environ, COCO_ROOT=coco_root),
        osp.join(workdir, "logs"), val_img, osp.join(workdir, "demo_out"),
        "validation/main/map@0.5")

    summary = {
        "check": "coco_rehearsal",
        "map@0.5": float(eval_result.get("validation/main/map@0.5",
                                         float("nan"))),
        "map": float(eval_result.get("validation/main/map", float("nan"))),
        "steps": int(entries[-1].get("iteration", 0)),
        "log_dir": log_dir,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
