"""bf16-vs-float32 system-level accuracy comparison on a synthetic val
split, the port of ``examples/check_dtype_parity.py``.

Runs the synthetic-COCO dress rehearsal (``check_coco_rehearsal``: the
unmodified driver journey) twice with the same data, seed and recipe,
differing only in ``--compute-dtype``, then prints a side-by-side mAP
comparison as one JSON line. The default 96-image (~300-instance) minival
keeps the delta's noise floor well below the effect it measures.

On the card, at the defaults:
    python -m mask_rcnn_tpu_torch.examples.check_dtype_parity
Tiny run of the plumbing:
    python -m mask_rcnn_tpu_torch.examples.check_dtype_parity \\
        --min-size 64 --max-size 96 --max-epoch 2 --n-val 4 --min-map -1

``--device`` is passed to the rehearsal (and so to its drivers), which run
on the card unless it says ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys
import tempfile

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def run_one(dtype, args, workdir):
    cmd = [
        sys.executable, "-m",
        "mask_rcnn_tpu_torch.examples.check_coco_rehearsal",
        "--workdir", workdir,
        "--compute-dtype", dtype,
        "--max-epoch", str(args.max_epoch),
        "--n-val", str(args.n_val),
        "--seed", str(args.seed),
        "--min-map", str(args.min_map),
        # evaluate the big val split at the midpoint + end only: the
        # measured number is the final evaluate pass either way
        "--eval-interval-epochs", str(args.max_epoch / 2),
        "--device", args.device,
    ]
    if args.min_size:
        cmd += ["--min-size", str(args.min_size)]
    if args.max_size:
        cmd += ["--max-size", str(args.max_size)]
    print(f"$ {' '.join(cmd)}", flush=True)
    res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    print(res.stdout[-3000:], flush=True)
    if res.returncode != 0:
        raise SystemExit(f"{dtype} rehearsal failed ({res.returncode})")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    """Returns the comparison (also printed as the last line)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--max-epoch", type=float, default=250.0)
    parser.add_argument("--n-val", type=int, default=96)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--min-map", type=float, default=0.5)
    parser.add_argument("--min-size", type=int, default=None)
    parser.add_argument("--max-size", type=int, default=None)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the rehearsals' drivers")
    args = parser.parse_args(argv)

    base = args.workdir or tempfile.mkdtemp(prefix="dtype_parity_")
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = run_one(dtype, args, osp.join(base, dtype))

    f32, bf16 = out["float32"], out["bfloat16"]
    result = {
        "check": "dtype_parity",
        "n_val_images": args.n_val,
        "f32": {"map@0.5": f32["map@0.5"], "map": f32["map"]},
        "bf16": {"map@0.5": bf16["map@0.5"], "map": bf16["map"]},
        "delta_map@0.5": round(bf16["map@0.5"] - f32["map@0.5"], 4),
        "delta_map": round(bf16["map"] - f32["map"], 4),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
