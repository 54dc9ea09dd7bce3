"""Finding what a cell is made of, by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration, traffic and metrics; each
of those is a file of its own under ``port_bench/``:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  model's architecture (``architecture``), sizes (``model``), training's
  settings (``train``) and the weights' scales (``weights``);
* ``archs/<architecture>.py``: everything that depends on the model's
  architecture, which the harness reaches only through ``Cell.arch``:
  ``port_config(model)`` (the port's config object), ``layout(model,
  stds)`` (the weights' draw order and shapes), ``anchor_count(model, h,
  w)``, ``predict_flops(model, h, w, n_images, n_dets)``,
  ``train_flops(model, train, h, w, n_images)``, ``serve_rooflines(run,
  summary, shapes)`` and ``train_rooflines(run, summary, n_steps, batch)``
  (``{kernel: (floor seconds, device seconds)}`` of a traced segment), and
  the reference's ``detect``, ``score_rois``, ``mask_probs`` and
  ``train_loss``, whose features nothing else looks into;
* ``traffic/<traffic>.json``: the traffic's parameters, whose ``mode``
  names the code that runs it (``modes/<mode>.py``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``.

A new cell, configuration, architecture or metric is new files and new
entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os.path as osp
import types

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
    arch: types.ModuleType

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
    if "architecture" not in config:
        raise ValueError(f"{conf['file']} names no 'architecture' (the "
                         "module port_bench/archs/<architecture>.py)")
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
                [m for m in bench["per_layer"] if _applies(m, name)], root,
                architecture(root, config["architecture"]))


def mode(cell: Cell):
    return importlib.import_module(f"port_bench.modes.{cell.mode}")


def _load(root, folder, name):
    """The module ``port_bench/<folder>/<name>.py`` under ``root``, loaded
    by its path."""
    path = osp.join(root, "port_bench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def architecture(root: str, name: str):
    """The module ``archs/<name>.py`` under ``root``."""
    return _load(root, "archs", name)


def reader(cell: Cell, metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return _load(cell.root, "metrics", metric).read
