"""A cell, a configuration and a per-layer metric added as files of their
own, with entries in ``BENCHMARK.json``, are found without an edit to any
file that is there."""

import json
import os.path as osp

from port_bench import spec
from port_bench.tests import tiny


def test_new_files_are_found(tmp_path):
    root = tiny.make_root(str(tmp_path))
    with open(osp.join(root, "port_bench", "metrics", "answer.stream.py"),
              "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    with open(osp.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "answer.stream", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device",
                               "moves": "serve_images_per_s",
                               "workloads": ["tiny.stream"]})
    with open(osp.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load("tiny.stream", root)
    assert cell.config["model"] == tiny.MODEL
    assert cell.traffic == tiny.TRAFFIC["tiny-stream"]
    assert cell.limits == tiny.LIMITS["tiny.stream"]
    names = [m["name"] for m in cell.per_layer]
    assert "answer.stream" in names and "mfu.stream" in names
    assert "mfu.train" not in names
    assert spec.reader(cell, "answer.stream")(None) == 42.0
    assert spec.mode(cell).__name__ == "port_bench.modes.stream"
    e2e = [m["name"] for m in cell.end_to_end]
    assert e2e == ["serve_images_per_s", "setup_s"]


def test_every_metric_of_the_benchmark_has_its_reader():
    with open(osp.join(tiny.REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        for m in cell.per_layer:
            assert callable(spec.reader(cell, m["name"]))
        assert spec.mode(cell)
