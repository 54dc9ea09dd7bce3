"""Everything that depends on the model's architecture sits behind
``archs/<name>.py``, which the configuration's ``architecture`` names:

* the C4 module's FLOPs, byte floors, anchor counts, rooflines, weights and
  reference equal the values that the harness gave before they moved
  there, exactly (the weights as a sha256 of their leaves in layout order;
  the reference's floats to the last bit, recorded on an x86-64 CPU at two
  threads, the only setting at which they are bit for bit the same);
* a configuration of a new architecture loads with new files alone;
* a configuration that names no architecture fails at ``spec.load``;
* no module of the harness outside ``archs/`` and ``reference/`` names a
  part of the C4 model.
"""

import glob
import hashlib
import json
import os.path as osp
import types

import pytest
import torch

from port_bench import counts, spec, traffic, weights
from port_bench.modes import train as td
from port_bench.reference import model as R
from port_bench.tests import tiny

C4 = spec.architecture(tiny.REPO, "c4")
PEAKS = counts.CARDS["NVIDIA H100 80GB HBM3"]
TRAIN_CELL = {"r50-c4-coco": "r50c4-coco-train-b4",
              "r101-c4-coco": "r101c4-coco-train-b4"}

# (configuration, padded (h, w)) -> predict FLOPs of 4 images with 400
# detections and of 1 image with 100, train FLOPs of 4 images, K1's bytes at
# 4 images and 1000 / 100 rois, K7's bytes at 4 images and 512 rois, anchors
# of one image, K1's floor seconds over a batch of 4 and one of 1, K7's over
# 3 steps of 4 images
GOLDEN = {
    ("r50-c4-coco", (832, 1344)): (
        7424513146880, 1856128286720, 11700069335040, 437254656, 75929856,
        241336320, 65520, 0.00019148675820895522, 0.0002161220776119403),
    ("r50-c4-coco", (1344, 832)): (
        7424513146880, 1856128286720, 11700069335040, 437254656, 75929856,
        241336320, 65520, 0.00019148675820895522, 0.0002161220776119403),
    ("r50-c4-coco", (1344, 1344)): (
        7971822632960, 1992955658240, 13155443539968, 459274752, 97949952,
        263356416, 105840, 0.0002079196656716418, 0.00023584156656716418),
    ("r101-c4-coco", (832, 1344)): (
        8086349152256, 2021587288064, 13685577351168, 437254656, 75929856,
        241336320, 65520, 0.00019148675820895522, 0.0002161220776119403),
    ("r101-c4-coco", (1344, 832)): (
        8086349152256, 2021587288064, 13685577351168, 437254656, 75929856,
        241336320, 65520, 0.00019148675820895522, 0.0002161220776119403),
    ("r101-c4-coco", (1344, 1344)): (
        9040942333952, 2260235583488, 16362802642944, 459274752, 97949952,
        263356416, 105840, 0.0002079196656716418, 0.00023584156656716418),
}
WEIGHTS_SHA256 = {
    "r50-c4-coco": (
        "a0efcbb85dee758b0341b4fed1d729780ff929db9800ba81417e7680db338f24",
        173),
    "r101-c4-coco": (
        "2f77ae48b785a588ca33be4aedaadd9d8595eb2933a3ce0ee33e1c54b518dd0b",
        326),
}
TINY_SEED = 987654321012
TINY_WEIGHTS_SHA256 = (
    "b516d0c8d3cd41915e8421c4fb64c31bab05fde6eb0e64fbdf3cc4120d09665d")
TINY_DETECT = {
    "boxes": "5cceb9475e8f6a226bdaff31dabd52ccc52c97ecbd4924e563f8496207b29431",
    "labels": [3, 3, 3, 0, 3, 3, 3, 3, 3, 3],
    "scores": ["0x1.ae5ffa0000000p-2", "0x1.9c5a280000000p-2",
               "0x1.8f10400000000p-2", "0x1.81c06c0000000p-2",
               "0x1.81085e0000000p-2", "0x1.7e7a640000000p-2",
               "0x1.7dd69e0000000p-2", "0x1.7d226a0000000p-2",
               "0x1.7cdeaa0000000p-2", "0x1.7cca6c0000000p-2"],
    "masks": "412c40fda6de55657d5fb51103262828b689913a65b1f5f4c7b506e4b7a34176",
    "score_rois": (
        "e80aa4df249c344f3ea0d7ee9e0f8df0eccbdeeb6a72ea928d2edfdaf5fb4831"),
}
TINY_TERMS = {"rpn_loc_loss": "0x1.4009a40000000p-4",
              "rpn_cls_loss": "0x1.6e3d8e0000000p-1",
              "roi_loc_loss": "0x1.3257100000000p-2",
              "roi_cls_loss": "0x1.89f6420000000p+1",
              "roi_mask_loss": "0x1.c530460000000p-1"}
TINY_LOSS = "0x1.438e720000000p+2"
C4_ONLY = ("feat_stride", "rpn_hidden", "head_chunked", "roi_align_fwd_kernel",
           "roi_align_bwd_kernel", "MaskRCNNConfig")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _digest(params, layout):
    """sha256 of every leaf's name and bytes, in layout order."""
    h = hashlib.sha256()
    n = 0
    for path, (kind, *_) in layout:
        for leaf in ([path + "/scale", path + "/bias"] if kind == "affine"
                     else [path]):
            node = params
            for k in leaf.split("/"):
                node = node[k]
            h.update(leaf.encode())
            h.update(node.contiguous().numpy().tobytes())
            n += 1
    return h.hexdigest(), n


@pytest.mark.parametrize("name,shape", sorted(GOLDEN))
def test_counts_floors_and_anchors_are_the_parents(name, shape):
    cell = spec.load(TRAIN_CELL[name])
    assert cell.arch.__file__ == C4.__file__
    m, tr = cell.config["model"], cell.config["train"]
    h, w = shape
    hf, wf, dtype = h // 16, w // 16, m["compute_dtype"]
    run = types.SimpleNamespace(model=m, peaks=PEAKS, cell=cell)
    batch = {"image": torch.empty((4, h, w, 3), device="meta"),
             "bbox": torch.empty((4, 64, 4), device="meta")}
    summary = {"device_s": {"roi_align_fwd_kernel": 0.25,
                            "roi_align_bwd_kernel": 0.5},
               "device_count": {"roi_align_fwd_kernel": 4,
                                "roi_align_bwd_kernel": 3}}
    got = (cell.arch.predict_flops(m, h, w, 4, 400),
           cell.arch.predict_flops(m, h, w, 1, 100),
           cell.arch.train_flops(m, tr, h, w, 4),
           cell.arch.roi_align_bytes(4, hf, wf, 1000, m, dtype),
           cell.arch.roi_align_bytes(4, hf, wf, 100, m, dtype),
           cell.arch.roi_align_bwd_bytes(4, hf, wf, 512, m, dtype),
           td._sizes(run, batch)[3],
           cell.arch.serve_rooflines(run, summary, [(shape, 4), (shape, 1)])
           ["roi_align"][0],
           cell.arch.train_rooflines(run, summary, 3, batch)
           ["roi_align_bwd"][0])
    assert got == GOLDEN[name, shape]
    assert cell.arch.serve_rooflines(run, summary, [(shape, 4)] * 2) == {
        "roi_align": (cell.arch.roi_align_floor(run, [(shape, 4)] * 2, 100),
                      0.25)}
    with pytest.raises(RuntimeError, match="4 RoIAlign launches for 3"):
        cell.arch.serve_rooflines(run, summary, [(shape, 4)] * 3)
    with pytest.raises(RuntimeError, match="3 RoIAlign backward"):
        cell.arch.train_rooflines(run, summary, 2, batch)


@pytest.mark.parametrize("name", sorted(WEIGHTS_SHA256))
def test_weights_are_the_parents(name):
    cell = spec.load(TRAIN_CELL[name])
    params = weights.of_config(cell.arch, cell.config, "cpu")
    layout = cell.arch.layout(cell.config["model"], cell.config["weights"])
    assert _digest(params, layout) == WEIGHTS_SHA256[name]


def test_the_tiny_reference_detects_as_the_parent():
    params = weights.make(C4, tiny.MODEL, tiny.WEIGHTS, TINY_SEED, "cpu")
    assert _digest(params, C4.layout(tiny.MODEL, tiny.WEIGHTS))[0] == \
        TINY_WEIGHTS_SHA256
    imgs = traffic.serve_batches(tiny.TRAFFIC["tiny-stream"], TINY_SEED,
                                 "cpu")[0]
    shape = R.batch_shape(tiny.MODEL, [im.shape[1:] for im in imgs])
    with torch.no_grad():
        d = C4.detect(params, tiny.MODEL, imgs[0], shape, R.FULL, "cpu")
        probs = C4.mask_probs(params, tiny.MODEL, d["features"], d["boxes"],
                              d["labels"], d["scale"], R.FULL)
        o = C4.score_rois(params, tiny.MODEL, d["features"],
                          d["anchor_rois"][:64], R.FULL)
    got = {"boxes": _sha(d["boxes"]), "labels": d["labels"].tolist(),
           "scores": [float(x).hex() for x in d["scores"]],
           "masks": _sha(probs), "score_rois": _sha(o["cls_loc"], o["score"])}
    assert got == TINY_DETECT


def test_the_tiny_reference_loss_is_the_parents():
    params = weights.make(C4, tiny.MODEL, tiny.WEIGHTS, TINY_SEED, "cpu")
    b = traffic.train_batches(tiny.TRAFFIC["tiny-train"], tiny.MODEL,
                              TINY_SEED, "cpu")[0]
    n, h, w = b["image"].shape[:3]
    pri = traffic.priorities({}, TINY_SEED, 0, n,
                             C4.anchor_count(tiny.MODEL, h, w),
                             100 + b["bbox"].shape[1], "cpu")
    loss, terms = C4.train_loss(params, tiny.config(), b, pri, R.FULL)
    assert {k: float(v).hex() for k, v in terms.items()} == TINY_TERMS
    assert float(loss).hex() == TINY_LOSS


STUB = '''"""An architecture of two leaves, for the test of the seam."""

NAME = "stub"


def layout(model, stds):
    return [("body/W", ("normal", (2, model["width"]), stds["body"])),
            ("body/bn", ("affine", 2, 0.5))]


def anchor_count(model, h, w):
    return h * w * model["width"]
'''


def _stub_root(root, config):
    """A checkout of data files and the stub architecture alone; -> the
    files written."""
    files = {
        "BENCHMARK.json": {
            "configs": [{"name": "stub", "source": "test",
                         "file": "port_bench/configs/stub.json",
                         "reduced": [], "why": "test"}],
            "workloads": [{"name": "stub.train", "config": "stub",
                           "traffic": "stub-train", "chips": 1,
                           "why": "test"}],
            "end_to_end": [], "per_layer": []},
        "port_bench/configs/stub.json": config,
        "port_bench/traffic/stub-train.json": {"mode": "train"},
        "port_bench/archs/stub.py": STUB,
    }
    for rel, content in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content if isinstance(content, str)
                        else json.dumps(content))
    return sorted(files)


def test_a_new_architecture_is_new_files_alone(tmp_path):
    config = {"architecture": "stub",
              "model": {"width": 3, "proposal": {"n_train_post_nms": 5}},
              "weights": {"seed": 1, "body": 2.0}}
    written = _stub_root(tmp_path, config)
    assert sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
                  if p.is_file()) == written
    cell = spec.load("stub.train", str(tmp_path))
    assert cell.arch.NAME == "stub"
    assert cell.arch.__file__ == str(tmp_path / "port_bench/archs/stub.py")
    assert spec.mode(cell) is td
    params = weights.of_config(cell.arch, cell.config, "cpu")
    assert params["body"]["W"].shape == (2, 3)
    assert params["body"]["bn"]["scale"].tolist() == [0.5, 0.5]
    run = types.SimpleNamespace(model=cell.config["model"], cell=cell)
    batch = {"image": torch.empty((1, 4, 5, 3), device="meta"),
             "bbox": torch.empty((1, 2, 4), device="meta")}
    assert td._sizes(run, batch) == (1, 4, 5, 60, 7)


def test_a_configuration_without_an_architecture_fails(tmp_path):
    _stub_root(tmp_path, {"model": {}, "weights": {"seed": 1}})
    with pytest.raises(ValueError, match="port_bench/configs/stub.json"):
        spec.load("stub.train", str(tmp_path))


@pytest.mark.parametrize("name", C4_ONLY)
def test_only_the_architecture_names_c4s_parts(name):
    pb = osp.join(tiny.REPO, "port_bench")
    files = glob.glob(osp.join(pb, "*.py")) + glob.glob(
        osp.join(pb, "modes", "*.py"))
    assert len(files) > 10
    assert [f for f in files if name in open(f).read()] == []
