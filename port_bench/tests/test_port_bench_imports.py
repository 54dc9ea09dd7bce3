"""Nothing that the command loads is JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port."""

import json
import os.path as osp
import subprocess
import sys

from port_bench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "mask_rcnn_tpu"}


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=tiny.REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax():
    code = ("import port_bench.run, port_bench.harness, port_bench.calibrate\n"
            "import port_bench.modes.stream, port_bench.modes.online\n"
            "import port_bench.modes.train\n"
            "from port_bench import spec\n"
            "cell = spec.load('r50c4-coco-stream-b4')\n"
            "cell.arch.port_config(cell.config['model'])\n"
            "import mask_rcnn_tpu_torch.models.api\n"
            "import mask_rcnn_tpu_torch.engine.trainer\n")
    names = _loaded(code)
    assert "mask_rcnn_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded("import port_bench.reference.model, "
                    "port_bench.reference.train, port_bench.check, "
                    "port_bench.counts, port_bench.traffic, "
                    "port_bench.weights\n"
                    "from port_bench import spec\n"
                    "spec.architecture('.', 'c4')")
    assert not names & (FORBIDDEN | {"mask_rcnn_tpu_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "mask_rcnn_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_a_bare_copy_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(osp.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(osp.join(tiny.REPO, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "r50c4-coco-stream-b4", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
