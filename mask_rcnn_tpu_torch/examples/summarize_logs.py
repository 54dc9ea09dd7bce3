"""One table over every run under a logs directory, the port of
``examples/summarize_logs.py`` (the reference's examples/summarize_logs.py):
``params.yaml``, the JSON ``log`` and ``snapshot_model.npz.eval_result.yaml``
of each ``logs/*`` directory -> one row.

    python -m mask_rcnn_tpu_torch.examples.summarize_logs [logs]

The files are read as JSON (what the port writes), YAML through a lazily
imported pyyaml (a JAX package's log dir); the table is plain text.
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp


def summarize_one(log_dir):
    from mask_rcnn_tpu_torch.utils.logging import load_yaml

    row = {"log_dir": osp.basename(log_dir)}
    params_path = osp.join(log_dir, "params.yaml")
    if osp.exists(params_path):
        p = load_yaml(params_path) or {}
        row["model"] = p.get("model", p.get("model_config", {}).get(
            "n_layers"))
        row["dataset"] = p.get("dataset")
        row["batch_size"] = p.get("batch_size")
        row["lr"] = p.get("lr")
        row["git_hash"] = p.get("git_hash")
        row["hostname"] = p.get("hostname")
    log_path = osp.join(log_dir, "log")
    if osp.exists(log_path):
        try:
            with open(log_path) as f:
                entries = json.load(f)
        except json.JSONDecodeError:
            entries = []
        maps = [
            e["validation/main/map"]
            for e in entries
            if "validation/main/map" in e
        ]
        if maps:
            row["best_map"] = max(maps)
        if entries:
            row["iteration"] = entries[-1].get("iteration")
            row["elapsed"] = entries[-1].get("elapsed_time")
    eval_path = osp.join(log_dir, "snapshot_model.npz.eval_result.yaml")
    if osp.exists(eval_path):
        ev = load_yaml(eval_path) or {}
        row["eval_map"] = ev.get("validation/main/map")
    return row


def format_table(rows) -> str:
    """Rows (dicts) -> a plain-text table: one column per key, in the order
    the keys first appear, an empty cell where a row lacks the key."""
    keys = []
    for row in rows:
        keys += [k for k in row if k not in keys]
    cells = [["" if row.get(k) is None else str(row[k]) for k in keys]
             for row in rows]
    widths = [max([len(k)] + [len(c[i]) for c in cells])
              for i, k in enumerate(keys)]

    def line(values):
        return "  ".join(v.ljust(w) for v, w in zip(values, widths)).rstrip()

    return "\n".join([line(keys), line(["-" * w for w in widths])]
                     + [line(c) for c in cells])


def main(argv=None):
    """Returns the rows, one per log dir."""
    parser = argparse.ArgumentParser()
    parser.add_argument("logs_dir", nargs="?", default="logs")
    args = parser.parse_args(argv)

    rows = [
        summarize_one(d)
        for d in sorted(glob.glob(osp.join(args.logs_dir, "*")))
        if osp.isdir(d)
    ]
    if not rows:
        print(f"no runs under {args.logs_dir}")
        return rows
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
