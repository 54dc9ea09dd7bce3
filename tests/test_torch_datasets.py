"""The port's image codec, polygon rasterizer, datasets and synthetic roots
against the JAX package's (and cv2's and PIL's) on the CPU. Every dataset
example must equal the JAX package's exactly (image, bboxes, labels,
masks, crowds, areas) on roots the JAX generators and tests write."""

import json
import os
import warnings

import cv2
import numpy as np
import PIL.Image
import pytest
import scipy.io

from mask_rcnn_tpu.data import coco as jax_coco
from mask_rcnn_tpu.data import concat as jax_concat
from mask_rcnn_tpu.data import legacy as jax_legacy
from mask_rcnn_tpu.data import synthetic as jax_synthetic
from mask_rcnn_tpu.data import voc as jax_voc
from mask_rcnn_tpu.utils.rle import mask_to_rle_counts
from mask_rcnn_tpu_torch.data import _image, coco, synthetic, voc
from mask_rcnn_tpu_torch.data.concat import ConcatDataset
from mask_rcnn_tpu_torch.data.legacy import MaskRcnnDataset
from mask_rcnn_tpu_torch.data.loader import TrainLoader
from mask_rcnn_tpu_torch.utils.logging import load_params_yaml


def assert_examples_equal(jax_ds, port_ds):
    assert len(jax_ds) == len(port_ds)
    for i in range(len(jax_ds)):
        want, got = jax_ds[i], port_ds[i]
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=f"example {i}")


# -- the PNG codec and headers -------------------------------------------

@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 2), (23, 31, 3),
                                   (23, 31, 4)])
def test_png_roundtrip(tmp_path, shape):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    _image.write_png(path, img)
    np.testing.assert_array_equal(_image.read_png(path), img)
    # a standard decoder reads the port's files
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(path)), img)
    assert _image.image_size(path) == shape[:2]


@pytest.mark.parametrize("shape,smooth", [
    ((37, 53), False), ((37, 53, 3), False), ((37, 53, 4), False),
    ((64, 96, 3), True),  # smooth: libpng picks its Sub/Up/Avg/Paeth rows
])
def test_png_reads_like_cv2(tmp_path, shape, smooth):
    """Pixels identical to ``cv2.imread`` on files cv2 wrote (libpng's
    adaptive filters), as RGB and unchanged."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    if smooth:
        img = (np.indices(shape[:2]).sum(0)[..., None] * [1, 2, 3]
               + rng.randint(0, 3, shape)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(
        _image.read_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw.ndim == 3:  # BGR(A) -> RGB(A)
        raw = raw[..., [2, 1, 0, 3][:raw.shape[2]]]
    np.testing.assert_array_equal(_image.read_png(path), raw)


def test_palette_png_gives_indices(tmp_path):
    """A palette PNG reads as its indices (the VOC label reader's need) and,
    through ``read_rgb``, as cv2's expansion of the palette."""
    rng = np.random.RandomState(2)
    lbl = rng.randint(0, 21, (50, 70)).astype(np.uint8)
    lbl[0] = 255
    im = PIL.Image.fromarray(lbl, mode="L")
    im.putpalette(rng.randint(0, 256, 768).astype(np.uint8).tolist())
    assert im.mode == "P"
    path = str(tmp_path / "p.png")
    im.save(path)
    np.testing.assert_array_equal(_image.read_png(path),
                                  np.asarray(PIL.Image.open(path)))
    np.testing.assert_array_equal(
        _image.read_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_image_size_matches_pil(tmp_path, ext):
    path = str(tmp_path / f"a.{ext}")
    img = np.random.RandomState(3).randint(0, 256, (41, 67, 3))
    assert cv2.imwrite(path, img.astype(np.uint8))
    w, h = PIL.Image.open(path).size
    assert _image.image_size(path) == (h, w)


def test_read_rgb_jpeg_and_errors(tmp_path):
    path = str(tmp_path / "a.jpg")
    img = np.random.RandomState(4).randint(0, 256, (30, 40, 3))
    assert cv2.imwrite(path, img.astype(np.uint8))
    np.testing.assert_array_equal(_image.read_rgb(path),
                                  cv2.imread(path)[..., ::-1])
    assert _image.jpeg_decoder() == "cv2"
    with pytest.raises(IOError):
        _image.read_rgb(str(tmp_path / "missing.png"))
    good = str(tmp_path / "g.png")
    _image.write_png(good, img.astype(np.uint8))
    cut = tmp_path / "cut.png"
    cut.write_bytes(open(good, "rb").read()[:60])
    with pytest.raises(IOError):
        _image.read_rgb(str(cut))
    flipped = bytearray(open(good, "rb").read())
    flipped[45] ^= 0xFF  # inside IDAT: the CRC no longer matches
    (tmp_path / "crc.png").write_bytes(bytes(flipped))
    with pytest.raises(IOError):
        _image.read_png(str(tmp_path / "crc.png"))
    (tmp_path / "x.bin").write_bytes(b"neither")
    with pytest.raises(IOError):
        _image.image_size(str(tmp_path / "x.bin"))


# -- the polygon rasterizer against PIL -----------------------------------

def _truncated(poly):
    return [tuple(v) for v in
            np.trunc(np.asarray(poly, float).reshape(-1, 2)).astype(int)]


def _revisits_vertex(poly):
    v = _truncated(poly)
    return len(v) >= 3 and len(set(v)) < len(v)


def _polygons(kind, rng, h, w):
    """One object's polygons of the property class ``kind``."""
    side = max(h, w)

    def rand_poly(lo, hi, n, integer=False):
        p = rng.uniform(lo, hi, 2 * n)
        return (np.floor(p) if integer else p).tolist()

    if kind == "float":
        return [rand_poly(0, side, rng.randint(3, 9))]
    if kind == "integer":
        return [rand_poly(0, side, rng.randint(3, 9), integer=True)]
    if kind == "off_canvas":
        return [rand_poly(-side, 2 * side, rng.randint(3, 9))]
    if kind == "few_points":  # 1 and 2 points are skipped, 3 drawn
        return [rand_poly(0, side, n) for n in (1, 2, 3)]
    if kind == "collinear":
        t = np.sort(rng.uniform(-0.2, 1.2, rng.randint(3, 7)))
        a, b = rng.uniform(0, side, 2), rng.uniform(0, side, 2)
        pts = a[None] + t[:, None] * (b - a)[None]
        if rng.rand() < 0.5:
            pts = np.floor(pts)
        return [pts.ravel().tolist()]
    if kind == "self_intersecting":  # unordered vertices cross themselves
        return [rand_poly(-2, side + 2, rng.randint(5, 13))]
    if kind == "several":
        return [rand_poly(-2, side + 2, rng.randint(3, 9))
                for _ in range(rng.randint(2, 5))]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["float", "integer", "off_canvas",
                                  "few_points", "collinear",
                                  "self_intersecting", "several"])
def test_polygon_rasterizer_matches_pil(kind):
    """Pixel for pixel against PIL's ``ImageDraw.polygon(outline=1,
    fill=1)`` on one shared canvas (the JAX package's rasterizer), for
    every polygon whose vertices, truncated to integers as PIL truncates
    them, are all distinct (those that revisit a vertex: the next test)."""
    rng = np.random.RandomState(["float", "integer", "off_canvas",
                                 "few_points", "collinear",
                                 "self_intersecting", "several"].index(kind))
    checked = 0
    for _ in range(300):
        h, w = rng.randint(5, 48), rng.randint(5, 48)
        polys = _polygons(kind, rng, h, w)
        if any(_revisits_vertex(p) for p in polys):
            continue
        np.testing.assert_array_equal(
            coco.polygons_to_mask(polys, h, w),
            jax_coco.polygons_to_mask(polys, h, w),
            err_msg=f"{kind}: {polys} on {h}x{w}")
        checked += 1
    assert checked >= 200


def test_polygon_rasterizer_revisited_vertex_bound():
    """Polygons whose truncated vertices repeat (a spike A-B-A, or a path
    back through an earlier vertex): PIL's corner rule at such a vertex is
    not reproduced in every case. The seam is bounded: at most 2% of these
    polygons differ, by at most 24 pixels, all on rows that hold a vertex
    (canvases up to 40x40; measured on 20,000 such polygons: 0.6% differ,
    by at most 20 pixels)."""
    rng = np.random.RandomState(0)
    n, n_diff = 1000, 0
    for _ in range(n):
        h, w = rng.randint(5, 40), rng.randint(5, 40)
        pts = rng.randint(-2, max(h, w) + 2, (rng.randint(3, 9), 2))
        pts = np.insert(pts.astype(float), rng.randint(len(pts) + 1),
                        pts[rng.randint(len(pts))], axis=0)
        if rng.rand() < 0.5:
            pts = pts + rng.uniform(0, 0.99, pts.shape)  # same truncation
        poly = [pts.ravel().tolist()]
        diff = np.argwhere(coco.polygons_to_mask(poly, h, w)
                           != jax_coco.polygons_to_mask(poly, h, w))
        if len(diff):
            n_diff += 1
            assert len(diff) <= 24, (poly, h, w)
            rows = {y for _, y in _truncated(poly[0])}
            assert set(diff[:, 0].tolist()) <= rows, (poly, h, w)
    assert n_diff <= 0.02 * n


def test_polygon_rasterization_pil_parity():
    """The JAX package's own parity case (tests/test_coco_data.py)."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        polys = [(rng.rand(rng.randint(3, 8) * 2) * 28.0).tolist()
                 for _ in range(rng.randint(1, 4))]
        np.testing.assert_array_equal(coco.polygons_to_mask(polys, 30, 32),
                                      jax_coco.polygons_to_mask(polys, 30,
                                                                32))


def test_segmentation_to_mask_rle():
    m = np.zeros((8, 9), np.uint8)
    m[2:5, 3:7] = 1
    for segm in ({"size": [8, 9], "counts": mask_to_rle_counts(m).tolist()},
                 {"size": [8, 9], "counts": jax_coco.rle_util.encode_mask(
                     m)["counts"]}):
        np.testing.assert_array_equal(coco.segmentation_to_mask(segm, 8, 9),
                                      m)


# -- COCO ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """tests/test_coco_data.py's fixture: cv2 JPEGs, polygons, an RLE
    crowd, an image without annotations."""
    root = tmp_path_factory.mktemp("coco")
    os.makedirs(root / "train2014")
    os.makedirs(root / "annotations")
    rng = np.random.RandomState(0)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, 4):
        h, w = 60, 80
        name = f"COCO_train2014_{img_id:012d}.jpg"
        cv2.imwrite(str(root / "train2014" / name),
                    rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        y1, x1, y2, x2 = 10, 10 + img_id, 40, 50
        annotations.append({
            "id": ann_id, "image_id": img_id, "category_id": 18,
            "segmentation": [[x1, y1, x2, y1, x2, y2, x1, y2]],
            "iscrowd": 0, "area": (x2 - x1) * (y2 - y1)})
        ann_id += 1
        if img_id == 1:
            m = np.zeros((h, w), np.uint8)
            m[45:55, 60:75] = 1
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": 44,
                "segmentation": {"size": [h, w],
                                 "counts": mask_to_rle_counts(m).tolist()},
                "iscrowd": 1, "area": int(m.sum())})
            ann_id += 1
    images.append({"id": 4, "file_name": "COCO_train2014_000000000004.jpg",
                   "height": 60, "width": 80})
    cv2.imwrite(str(root / "train2014" / images[-1]["file_name"]),
                np.zeros((60, 80, 3), np.uint8))
    with open(root / "annotations" / "instances_train2014.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 18, "name": "dog"},
                                  {"id": 44, "name": "bottle"}]}, f)
    return str(root)


@pytest.mark.parametrize("crowd", [False, True])
def test_coco_dataset_matches_jax(mini_coco, crowd):
    kw = dict(use_crowd=True, return_crowd=True,
              return_area=True) if crowd else {}
    port = coco.COCOInstanceSegmentationDataset("train", root=mini_coco,
                                                **kw)
    assert len(port) == 3  # the image without annotations is filtered
    assert port.class_names == ("dog", "bottle")
    assert_examples_equal(
        jax_coco.COCOInstanceSegmentationDataset("train", root=mini_coco,
                                                 **kw), port)
    assert port.image_sizes() == [(60, 80)] * 3
    with pytest.raises(FileNotFoundError):
        coco.COCOInstanceSegmentationDataset("minival", root=mini_coco)


@pytest.fixture(scope="module")
def coco_roots(tmp_path_factory):
    """The JAX and the port's synthetic COCO roots from one seed."""
    base = tmp_path_factory.mktemp("coco_roots")
    kw = dict(n_train=3, n_valminusminival=1, n_minival=2, height=64,
              width=96, seed=5)
    return (jax_synthetic.make_synthetic_coco_root(str(base / "jax"), **kw),
            synthetic.make_synthetic_coco_root(str(base / "port"), **kw))


def test_synthetic_coco_root_matches_jax(coco_roots):
    """The same JSON, and the same pixels (the port writes its own PNGs,
    the JAX generator cv2's)."""
    jroot, proot = coco_roots
    for split in ("train2014", "valminusminival2014", "minival2014"):
        name = os.path.join("annotations", f"instances_{split}.json")
        with open(os.path.join(jroot, name)) as a, \
                open(os.path.join(proot, name)) as b:
            assert json.load(a) == json.load(b)
    for sub in ("train2014", "val2014"):
        files = sorted(os.listdir(os.path.join(jroot, sub)))
        assert files == sorted(os.listdir(os.path.join(proot, sub)))
        for f in files:
            np.testing.assert_array_equal(
                _image.read_rgb(os.path.join(proot, sub, f)),
                cv2.imread(os.path.join(jroot, sub, f))[..., ::-1])


@pytest.mark.parametrize("split", ["train", "valminusminival", "minival"])
def test_coco_dataset_on_synthetic_roots(coco_roots, split):
    kw = dict(use_crowd=True, return_crowd=True,
              return_area=True) if split == "minival" else {}
    for root in coco_roots:
        assert_examples_equal(
            jax_coco.COCOInstanceSegmentationDataset(split, root=root, **kw),
            coco.COCOInstanceSegmentationDataset(split, root=root, **kw))


# -- VOC2012, SBD, VOC-like -----------------------------------------------

@pytest.fixture(scope="module", params=["gray", "palette"])
def mini_voc(tmp_path_factory, request):
    """tests/test_voc_data.py's fixture (cv2 JPEGs, gray label PNGs), and
    the same labels as palette PNGs, as VOC ships them."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass", "SegmentationObject",
              "ImageSets/Segmentation"):
        os.makedirs(root / d)
    rng = np.random.RandomState(0)
    ids = []
    for k in range(2):
        did = f"2012_{k:06d}"
        ids.append(did)
        h, w = 50, 70
        cv2.imwrite(str(root / "JPEGImages" / (did + ".jpg")),
                    rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        cls = np.zeros((h, w), np.uint8)
        obj = np.zeros((h, w), np.uint8)
        cls[5:20, 5:30], obj[5:20, 5:30] = 15, 1
        cls[25:45, 35:65], obj[25:45, 35:65] = 8, 2
        cls[0, :], obj[0, :] = 255, 255
        for arr, sub in ((cls, "SegmentationClass"),
                         (obj, "SegmentationObject")):
            im = PIL.Image.fromarray(arr)
            if request.param == "palette":
                im.putpalette(list(range(256)) * 3)
            im.save(root / sub / (did + ".png"))
    with open(root / "ImageSets/Segmentation/train.txt", "w") as f:
        f.write("\n".join(ids) + "\n")
    return str(root)


def test_voc2012_matches_jax(mini_voc):
    port = voc.VOC2012InstanceSegmentationDataset("train", root=mini_voc)
    assert_examples_equal(
        jax_voc.VOC2012InstanceSegmentationDataset("train", root=mini_voc),
        port)
    assert sorted(port[0][2].tolist()) == [7, 14]
    assert port.image_sizes() == [(50, 70)] * 2


def test_sbd_vendored_fcis_splits():
    for split in ("train", "val"):
        port = voc.SBDInstanceSegmentationDataset(split)
        assert port.ids == jax_voc.SBDInstanceSegmentationDataset(split).ids
    assert len(voc.SBDInstanceSegmentationDataset("train")) == 5623
    with pytest.raises(ValueError):
        voc.SBDInstanceSegmentationDataset("trainval")


@pytest.fixture(scope="module")
def sbd_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("sbd_roots")
    kw = dict(n_train=3, n_val=2, height=48, width=64, seed=3)
    return (jax_synthetic.make_synthetic_sbd_root(str(base / "jax"), **kw),
            synthetic.make_synthetic_sbd_root(str(base / "port"), **kw))


def test_synthetic_sbd_root_matches_jax(sbd_roots):
    """The same split lists, the same JPEG bytes (both through cv2 here)
    and the same ``.mat`` contents."""
    jroot, proot = sbd_roots
    for sub in ("ImageSets/Main", "img", "cls", "inst"):
        files = sorted(os.listdir(os.path.join(jroot, sub)))
        assert files == sorted(os.listdir(os.path.join(proot, sub)))
        for f in files:
            a, b = os.path.join(jroot, sub, f), os.path.join(proot, sub, f)
            if f.endswith(".mat"):
                key = "GTcls" if sub == "cls" else "GTinst"
                np.testing.assert_array_equal(
                    scipy.io.loadmat(a)[key][0][0]["Segmentation"],
                    scipy.io.loadmat(b)[key][0][0]["Segmentation"])
            else:
                assert open(a, "rb").read() == open(b, "rb").read(), f


@pytest.mark.parametrize("split", ["train", "val"])
def test_sbd_dataset_matches_jax(sbd_roots, split):
    for root in sbd_roots:
        port = voc.SBDInstanceSegmentationDataset(split, root=root)
        jax_ds = jax_voc.SBDInstanceSegmentationDataset(split, root=root)
        assert_examples_equal(jax_ds, port)
        assert port.image_sizes() == jax_ds.image_sizes()


def test_sbd_mat_fixture_matches_jax(tmp_path):
    """tests/test_voc_data.py's ``.mat`` fixture: 255 -> -1 in both label
    images, instances voided where the class is background or void."""
    root = tmp_path / "dataset"
    for d in ("img", "cls", "inst"):
        os.makedirs(root / d)
    h, w, did = 40, 60, "2008_000123"
    img = np.empty((h, w, 3), np.uint8)
    img[:] = (50, 100, 200)
    cv2.imwrite(str(root / "img" / (did + ".jpg")), img)
    cls = np.zeros((h, w), np.uint8)
    ins = np.zeros((h, w), np.uint8)
    cls[5:15, 5:25], ins[5:15, 5:25] = 12, 1
    cls[20:35, 30:55], ins[20:35, 30:55] = 12, 2
    cls[0, :], ins[0, :] = 255, 255
    ins[38, 0:10] = 3
    scipy.io.savemat(str(root / "cls" / (did + ".mat")),
                     {"GTcls": {"Segmentation": cls}})
    scipy.io.savemat(str(root / "inst" / (did + ".mat")),
                     {"GTinst": {"Segmentation": ins}})
    split = tmp_path / "split.txt"
    split.write_text(did + "\n")
    port = voc.SBDInstanceSegmentationDataset(root=str(root),
                                              split_file=str(split))
    assert_examples_equal(jax_voc.SBDInstanceSegmentationDataset(
        root=str(root), split_file=str(split)), port)
    assert port[0][2].tolist() == [11, 11]


def test_voclike_and_indexing_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    paths = ([], [], [])
    for k in range(3):
        img = rng.randint(0, 255, (30, 40, 3), dtype=np.uint8)
        cls = np.zeros((30, 40), np.int32)
        ins = np.zeros((30, 40), np.int32)
        cls[5:15, 5 + k:25], ins[5:15, 5 + k:25] = 2, 1
        cls[18:28, 10:30], ins[18:28, 10:30] = 1, 2
        name = f"a{k}.{'png' if k % 2 else 'jpg'}"
        cv2.imwrite(str(tmp_path / name), img)
        np.save(tmp_path / f"a{k}_cls.npy", cls)
        np.save(tmp_path / f"a{k}_ins.npy", ins)
        for lst, p in zip(paths, (name, f"a{k}_cls.npy", f"a{k}_ins.npy")):
            lst.append(str(tmp_path / p))
    names = ("x", "y", "z")
    port = voc.VOCLikeDataset(*paths, class_names=names)
    jax_ds = jax_voc.VOCLikeDataset(*paths, class_names=names)
    assert_examples_equal(jax_ds, port)
    assert port.image_sizes() == jax_ds.image_sizes() == [(30, 40)] * 3
    sub = voc.IndexingDataset(port, [2, 0])
    assert_examples_equal(jax_voc.IndexingDataset(jax_ds, [2, 0]), sub)
    assert sub.image_sizes() == [(30, 40)] * 2


def test_legacy_dataset_matches_jax():
    rng = np.random.RandomState(2)
    triples = []
    for _ in range(2):
        cls = np.zeros((20, 24), np.int32)
        ins = np.zeros((20, 24), np.int32)
        cls[2:9, 3:12], ins[2:9, 3:12] = 4, 1
        cls[11:18, 6:20], ins[11:18, 6:20] = 7, 2
        triples.append((rng.randint(0, 255, (20, 24, 3)).astype(np.uint8),
                        cls, ins))
    with pytest.warns(DeprecationWarning):
        port = MaskRcnnDataset(triples)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert_examples_equal(jax_legacy.MaskRcnnDataset(triples), port)


# -- concatenation ---------------------------------------------------------

@pytest.fixture(scope="module")
def coco_pair(tmp_path_factory):
    """tests/test_concat_dataset.py's landscape and portrait roots, written
    by the port's generator."""
    base = tmp_path_factory.mktemp("concat_coco")
    kw = dict(n_train=6, n_valminusminival=1, n_minival=1)
    root_l = synthetic.make_synthetic_coco_root(
        str(base / "L"), height=64, width=128, seed=0, **kw)
    root_p = synthetic.make_synthetic_coco_root(
        str(base / "P"), height=128, width=64, seed=1, **kw)
    return (coco.COCOInstanceSegmentationDataset("train", root=root_l),
            coco.COCOInstanceSegmentationDataset("train", root=root_p),
            root_l, root_p)


def test_concat_matches_jax_and_forwards_sizes(coco_pair):
    ds_l, ds_p, root_l, root_p = coco_pair
    cat = ConcatDataset(ds_l, ds_p)
    jcat = jax_concat.ConcatDataset(
        jax_coco.COCOInstanceSegmentationDataset("train", root=root_l),
        jax_coco.COCOInstanceSegmentationDataset("train", root=root_p))
    assert_examples_equal(jcat, cat)
    assert cat.image_sizes() == jcat.image_sizes()
    assert cat.class_names == ds_l.class_names
    assert cat[len(ds_l)][0].shape[:2] == (128, 64)
    with pytest.raises(IndexError):
        cat[len(cat)]
    with pytest.raises(ValueError):
        ConcatDataset()


def test_concat_keeps_aspect_grouping(coco_pair):
    ds_l, ds_p, _, _ = coco_pair
    cat = ConcatDataset(ds_l, ds_p)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # grouping active -> no warning
        loader = TrainLoader(cat, None, batch_size=2, min_size=64,
                             max_size=128, seed=0)
    assert loader.aspect_flags.sum() == len(ds_l)
    idx = loader.epoch_indices(0)
    assert len(idx) == 12
    for b in range(0, len(idx), 2):
        flags = loader.aspect_flags[idx[b:b + 2]]
        assert flags.all() or (~flags).all(), "mixed-orientation batch"


def test_bare_concat_without_metadata_warns(coco_pair):
    class Bare:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise AssertionError("not needed")

    cat = ConcatDataset(coco_pair[0], Bare())
    with pytest.raises(AttributeError):
        cat.image_sizes()
    with pytest.warns(UserWarning, match="aspect-ratio grouping disabled"):
        loader = TrainLoader(cat, None, batch_size=2, min_size=64,
                             max_size=128)
    assert loader.aspect_flags is None
    with pytest.raises(AttributeError):
        voc.IndexingDataset(Bare(), [0]).image_sizes()


# -- params.yaml -----------------------------------------------------------

def test_load_params_yaml_json_yaml_and_without_pyyaml(tmp_path,
                                                       monkeypatch):
    import sys

    import yaml

    want = {"model_config": {"n_fg_class": 3, "anchor_scales": [4, 8]},
            "lr": 0.0025}
    (tmp_path / "params.yaml").write_text(json.dumps(want))
    assert load_params_yaml(str(tmp_path)) == want
    (tmp_path / "params.yaml").write_text(yaml.safe_dump(want))
    assert load_params_yaml(str(tmp_path)) == want
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    with pytest.raises(ImportError, match="pyyaml"):
        load_params_yaml(str(tmp_path))
    (tmp_path / "params.yaml").write_text(json.dumps(want))
    assert load_params_yaml(str(tmp_path)) == want
