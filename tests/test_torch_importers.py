"""The port's weight importers and ``pretrained_model`` resolution against
the JAX package's, on the CPU. Both sides are numpy and pickle on the same
synthetic files (``tests/torch_import_cases.py``), so every comparison is
exact: the JAX importer's tree passed through the parameter bridge must
equal the port's tensors bit for bit."""

import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models.api import (
    resolve_pretrained_params as jax_resolve,
)
from mask_rcnn_tpu.ops.affine_channel import (
    fold_batch_norm as jax_fold_batch_norm,
)
from mask_rcnn_tpu.utils import detectron_import as jax_imp
from mask_rcnn_tpu.utils.checkpoint import flatten_params as jax_flatten
from mask_rcnn_tpu_torch.models import api
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig, init_params
from mask_rcnn_tpu_torch.ops.affine_channel import fold_batch_norm
from mask_rcnn_tpu_torch.utils import detectron_import as imp
from mask_rcnn_tpu_torch.utils.checkpoint import (
    flatten_params,
    params_from_numpy,
    params_to_numpy,
    save_params,
    unflatten_params,
)
from tests.torch_import_cases import write_detectron_pkl, write_imagenet_npz

SMALL_KW = dict(
    n_layers=50, n_fg_class=3, min_size=48, max_size=64,
    anchor_scales=(4.0, 8.0),
    proposal_creator_params=dict(n_test_pre_nms=80, n_test_post_nms=16),
    device="cpu",
)


def numpy_tree(params):
    """The port's params as the JAX package's numpy tree (HWIO)."""
    return unflatten_params(params_to_numpy(params))


def assert_tree_equal(got, want_numpy_tree):
    """``got`` (port tensors) equals the JAX-layout numpy tree passed
    through the bridge, leaf for leaf, bit for bit."""
    want = flatten_params(params_from_numpy(jax_flatten(want_numpy_tree)))
    got = flatten_params(got)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def assert_numpy_trees_equal(a, b):
    fa, fb = jax_flatten(a), jax_flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def detectron_pkl(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pkl") / "model_final.pkl")
    blobs = write_detectron_pkl(path, n_fg=3, n_anchor=2)
    return path, blobs


@pytest.fixture(scope="module")
def imagenet_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("imagenet") / "ResNet-50-model.npz")
    return path, write_imagenet_npz(path)


def test_detectron_import_schema(detectron_pkl):
    path, blobs = detectron_pkl
    got = imp.import_detectron_pkl(path, n_fg_class=3)
    assert_numpy_trees_equal(got, jax_imp.import_detectron_pkl(
        path, n_fg_class=3))

    # the conversion traps, on the port's own output
    want = np.transpose(blobs["conv1_w"], (2, 3, 1, 0))[:, :, ::-1, :]
    np.testing.assert_array_equal(got["extractor"]["conv1"]["W"], want)
    np.testing.assert_array_equal(
        got["rpn"]["loc"]["b"],
        blobs["rpn_bbox_pred_b"].reshape(2, 4)[:, [1, 0, 3, 2]].ravel())
    assert got["head"]["mask"]["W"].shape == (1, 1, 256, 3)

    # through the resolver: the schema of a config with 2 anchors, and the
    # JAX importer's tree through the bridge, bit for bit
    cfg = MaskRCNNConfig(n_fg_class=3, anchor_scales=(8.0,),
                         ratios=(0.5, 1.0))
    with torch.device("meta"):
        like = init_params(cfg, torch.Generator(), "meta")
    want = jax_imp.import_detectron_pkl(path, n_fg_class=3)
    assert_tree_equal(api.resolve_pretrained_params(path, like, cfg, "cpu"),
                      want)
    model = api.MaskRCNNResNet(n_fg_class=3, anchor_scales=(8.0,),
                               ratios=(0.5, 1.0), pretrained_model=path,
                               device="cpu")
    assert_tree_equal(model.params, want)


def test_imagenet_import(imagenet_npz):
    """'auto' semantics: BGR flip, BN fold (eps 1e-5), conv1-bias fold,
    res5 copied into the head, rpn/branches from ``like``."""
    path, flat = imagenet_npz
    cfg = MaskRCNNConfig(n_fg_class=4, anchor_scales=(8.0,))
    like = numpy_tree(init_params(cfg, torch.Generator().manual_seed(3),
                                  "cpu"))
    got = imp.import_imagenet_npz(path, like, n_layers=50)
    assert_numpy_trees_equal(
        got, jax_imp.import_imagenet_npz(path, like, n_layers=50))
    want = np.transpose(flat["conv1/W"], (2, 3, 1, 0))[:, :, ::-1, :]
    np.testing.assert_array_equal(got["extractor"]["conv1"]["W"], want)
    np.testing.assert_array_equal(got["rpn"]["conv1"]["W"],
                                  like["rpn"]["conv1"]["W"])
    np.testing.assert_array_equal(got["head"]["mask"]["W"],
                                  like["head"]["mask"]["W"])


def test_pretrained_model_auto_spec(imagenet_npz, tmp_path, monkeypatch):
    """'auto:<npz>' and 'imagenet:<npz>' take the path; 'auto' finds it
    through $MASK_RCNN_TPU_IMAGENET_NPZ, then the chainer cache and
    ~/data/models; a miss raises and fetches nothing."""
    path, _ = imagenet_npz
    cfg = MaskRCNNConfig(n_fg_class=2, anchor_scales=(8.0,))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = numpy_tree(params)
    want = jax_resolve(f"auto:{path}", like, cfg)
    for spec in (f"auto:{path}", f"imagenet:{path}"):
        assert_tree_equal(
            api.resolve_pretrained_params(spec, params, cfg, "cpu"), want)

    monkeypatch.setenv("MASK_RCNN_TPU_IMAGENET_NPZ", path)
    assert_tree_equal(
        api.resolve_pretrained_params("auto", params, cfg, "cpu"), want)
    assert api.find_imagenet_npz(50) == path

    monkeypatch.delenv("MASK_RCNN_TPU_IMAGENET_NPZ")
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    with pytest.raises(FileNotFoundError, match="drive.google.com"):
        api.resolve_pretrained_params("auto", params, cfg, "cpu")
    # the chainer dataset cache is the next place searched
    cache = home / ".chainer/dataset/pfnet/chainer/models"
    cache.mkdir(parents=True)
    (cache / "ResNet-50-model.npz").write_bytes(open(path, "rb").read())
    assert_tree_equal(
        api.resolve_pretrained_params("auto", params, cfg, "cpu"), want)
    # an ImageNet spec needs the initializer's values, not a meta tree
    with torch.device("meta"):
        meta = init_params(cfg, torch.Generator(), "meta")
    with pytest.raises(ValueError, match="initializ"):
        api.resolve_pretrained_params(f"auto:{path}", meta, cfg, "cpu")


def test_auto_keeps_rng_seed_heads(imagenet_npz, monkeypatch):
    """``MaskRCNNResNet(pretrained_model='auto')`` draws the initializer
    from ``rng_seed`` on the model's device and keeps its RPN and branch
    values; the backbone and res5 come from the npz."""
    path, _ = imagenet_npz
    monkeypatch.setenv("MASK_RCNN_TPU_IMAGENET_NPZ", path)
    fresh = api.MaskRCNNResNet(rng_seed=7, **SMALL_KW)
    model = api.MaskRCNNResNet(pretrained_model="auto", rng_seed=7,
                               **SMALL_KW)
    want = jax_imp.import_imagenet_npz(path, numpy_tree(fresh.params))
    assert_tree_equal(model.params, want)
    got, init = flatten_params(model.params), flatten_params(fresh.params)
    for k, v in init.items():
        if k.startswith("rpn/") or (k.startswith("head/")
                                    and not k.startswith("head/res5/")):
            assert torch.equal(got[k], v), k
        else:
            assert not torch.equal(got[k], v), k


def test_chainer_import_roundtrip(tmp_path):
    """Export the port's params in chainer layout, re-import: identity; the
    JAX exporter writes the same arrays and the JAX importer reads the same
    tree; a conv1 bias folds into bn1."""
    cfg = MaskRCNNConfig(n_fg_class=2, anchor_scales=(8.0,))
    params = numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    path = str(tmp_path / "snapshot_model.npz")
    jpath = str(tmp_path / "snapshot_model_jax.npz")
    imp.export_chainer_npz(params, path)
    jax_imp.export_chainer_npz(params, jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loaded = imp.import_chainer_npz(path)
    assert_numpy_trees_equal(loaded, params)
    assert_numpy_trees_equal(loaded, jax_imp.import_chainer_npz(path))

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    flat["extractor/conv1/b"] = np.random.RandomState(1).randn(64).astype(
        np.float32)
    path2 = str(tmp_path / "snapshot_model_b.npz")
    np.savez(path2, **flat)
    assert_numpy_trees_equal(imp.import_chainer_npz(path2),
                             jax_imp.import_chainer_npz(path2))


def test_chainer_depth_mismatch_raises(tmp_path):
    """A snapshot or tree whose depth disagrees with n_layers fails loudly
    in both directions, as the JAX importer does."""
    p101 = numpy_tree(init_params(MaskRCNNConfig(n_fg_class=2, n_layers=101),
                                  torch.Generator().manual_seed(0), "cpu"))
    for mod in (imp, jax_imp):
        with pytest.raises(ValueError, match="n_layers"):
            mod.export_chainer_npz(p101, str(tmp_path / "bad.npz"),
                                   n_layers=50)
    path101 = str(tmp_path / "r101.npz")
    imp.export_chainer_npz(p101, path101, n_layers=101)
    path50 = str(tmp_path / "r50.npz")
    imp.export_chainer_npz(
        numpy_tree(init_params(MaskRCNNConfig(n_fg_class=2),
                               torch.Generator().manual_seed(1), "cpu")),
        path50)
    for mod in (imp, jax_imp):
        with pytest.raises(ValueError, match="n_layers"):
            mod.import_chainer_npz(path101, n_layers=50)
        with pytest.raises(ValueError, match="n_layers"):
            mod.import_chainer_npz(path50, n_layers=101)


def test_chainer_snapshot_through_pretrained_model(tmp_path):
    """A reference-layout snapshot loads through ``pretrained_model=<path>``
    (layout-sniffed) and ``chainer:<path>``, equal to the JAX importer's
    tree through the bridge, and predicts as the donor does; a bridge npz
    still routes to ``load_params``."""
    donor = api.MaskRCNNResNet(rng_seed=7, **SMALL_KW)
    path = str(tmp_path / "snapshot_model.npz")
    imp.export_chainer_npz(numpy_tree(donor.params), path)
    assert imp.is_chainer_snapshot(path)
    want = jax_imp.import_chainer_npz(path)
    for spec in (path, f"chainer:{path}"):
        assert_tree_equal(
            api.MaskRCNNResNet(pretrained_model=spec, **SMALL_KW).params,
            want)

    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (3, 60, 80)).astype(np.float32)]
    ref = donor.predict(imgs)
    out = api.MaskRCNNResNet(pretrained_model=path, **SMALL_KW).predict(imgs)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a[0], b[0])

    native = str(tmp_path / "native.npz")
    save_params(native, donor.params)
    assert not imp.is_chainer_snapshot(native)
    got = flatten_params(
        api.MaskRCNNResNet(pretrained_model=native, **SMALL_KW).params)
    for k, v in flatten_params(donor.params).items():
        assert torch.equal(got[k], v), k


def test_snapshot_sniff_rejects_non_zip(tmp_path):
    not_zip = tmp_path / "weights.npy"
    not_zip.write_bytes(b"\x93NUMPY not a zip")
    for mod in (imp, jax_imp):
        assert not mod.is_chainer_snapshot(str(not_zip))
        assert not mod.is_chainer_snapshot(str(tmp_path))  # a directory
        assert not mod.is_chainer_snapshot(str(tmp_path / "missing.npz"))


def test_fold_batch_norm_matches_jax():
    """The port's fold against the JAX package's, float32, within one
    rounding of each result (XLA may evaluate the quotient as a product by
    a reciprocal square root)."""
    rng = np.random.RandomState(0)
    gamma, beta, mean = (rng.randn(256).astype(np.float32) for _ in range(3))
    var = (rng.rand(256) + 0.1).astype(np.float32)
    got = fold_batch_norm(*(torch.from_numpy(a)
                            for a in (gamma, beta, mean, var)))
    want = jax_fold_batch_norm(gamma, beta, mean, var)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2.4e-7, atol=1e-7)
