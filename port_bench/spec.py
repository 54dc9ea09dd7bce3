"""Finding what a cell is made of, by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration, traffic and metrics; each
of those is a file of its own under ``port_bench/``:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  model's sizes (``model``), training's settings (``train``) and the
  weights' scales (``weights``);
* ``traffic/<traffic>.json``: the traffic's parameters, whose ``mode``
  names the code that runs it (``modes/<mode>.py``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``.

A new cell, configuration or metric is new files and new entries: nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: str

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root`` (the
    checkout: the directory that holds ``port_bench``)."""
    root = root or osp.dirname(HERE)
    with open(osp.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(osp.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(osp.join(root, "port_bench", "traffic",
                       w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_file = osp.join(root, "port_bench", "limits", name + ".json")
    limits = {}
    if osp.exists(limits_file):
        with open(limits_file) as f:
            limits = json.load(f)
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def mode(cell: Cell):
    return importlib.import_module(f"port_bench.modes.{cell.mode}")


def reader(cell: Cell, metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = osp.join(cell.root, "port_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
