"""Run logging and provenance, the port of ``mask_rcnn_tpu/utils/logging.py``
(the reference's LogReport + ParamsReport).

The ``logs/<timestamp>/`` artifacts: ``params.yaml`` with the full config,
git hash and hostname, written as JSON (JSON is valid YAML, so the JAX
package's ``load_params_yaml`` reads it and the port needs no pyyaml); a
JSON ``log`` file of periodic metrics; loss/map plot PNGs when matplotlib is
installed. ``load_params_yaml`` reads either package's ``params.yaml``.
"""

from __future__ import annotations

import datetime
import json
import os
import os.path as osp
import socket
import subprocess
from typing import Dict, List, Optional


def git_hash(cwd: Optional[str] = None) -> Optional[str]:
    try:
        return (
            subprocess.check_output(
                ["git", "log", "-1", "--format=%h"],
                cwd=cwd or osp.dirname(osp.abspath(__file__)),
                stderr=subprocess.DEVNULL,
            )
            .decode()
            .strip()
        ) or None
    except Exception:
        return None


def timestamp_dir(base: str) -> str:
    name = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out = osp.join(base, name)
    os.makedirs(out, exist_ok=True)
    return out


def load_yaml(path: str):
    """Read a YAML file the port or the JAX package wrote: JSON (what the
    port writes, valid YAML) without pyyaml; YAML proper through a lazily
    imported pyyaml."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"{path} is YAML, not the JSON the port writes; reading it "
            "needs pyyaml, which is not installed"
        ) from e
    return yaml.safe_load(text)


def load_params_yaml(log_dir: str) -> Dict:
    """Read a log dir's ``params.yaml`` (:func:`load_yaml`): the port's
    without pyyaml, a JAX package's or reference log dir's through it."""
    return load_yaml(osp.join(log_dir, "params.yaml"))


def dump_params(out_dir: str, params: Dict) -> None:
    """Write ``params.yaml`` (as JSON) with the git hash, hostname and a
    timestamp added."""
    params = dict(params)
    params.setdefault("git_hash", git_hash())
    params.setdefault("hostname", socket.gethostname())
    params.setdefault("timestamp", datetime.datetime.now().isoformat())
    with open(osp.join(out_dir, "params.yaml"), "w") as f:
        json.dump(params, f, indent=2, default=str)
        f.write("\n")


class LogReport:
    """Append metric dicts to a chainer-style JSON ``log`` file (rewritten
    atomically on every append)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.path = osp.join(out_dir, "log")
        self._entries: List[Dict] = []
        if osp.exists(self.path):
            with open(self.path) as f:
                try:
                    self._entries = json.load(f)
                except json.JSONDecodeError:
                    self._entries = []

    def append(self, entry: Dict) -> None:
        self._entries.append(
            {
                k: (float(v) if hasattr(v, "__float__") else v)
                for k, v in entry.items()
            }
        )
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=2)
        os.replace(tmp, self.path)

    @property
    def entries(self):
        return list(self._entries)


def plot_metrics(out_dir: str, entries: List[Dict], keys: List[str],
                 filename: str) -> None:
    """Loss/accuracy PNG plots (PlotReport equivalent); no-op without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    xs = [e.get("iteration", i) for i, e in enumerate(entries)]
    plt.figure(figsize=(8, 5))
    plotted = False
    for k in keys:
        ys = [e.get(k) for e in entries]
        if any(y is not None for y in ys):
            plt.plot(xs, ys, label=k)
            plotted = True
    if plotted:
        plt.legend(fontsize=6)
    plt.xlabel("iteration")
    plt.grid(True, alpha=0.3)
    plt.savefig(osp.join(out_dir, filename), dpi=100)
    plt.close()
