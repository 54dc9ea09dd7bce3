"""Pretrained-weight importers, a numpy and pickle copy of
``mask_rcnn_tpu/utils/detectron_import.py`` (importing that package would
import jax).

``import_detectron_pkl``: Detectron e2e_mask_rcnn_R-50-C4_1x caffe2 blobs ->
the parameter tree. Replicates every conversion trap the reference
handles (examples/coco/convert_caffe2_to_chainer.py):
  * conv1 BGR->RGB input-channel flip (:47);
  * RPN and box-head loc coordinate reorder (dx,dy,dw,dh)->(dy,dx,dh,dw)
    (:183-195, :230-243);
  * mask logits background-channel drop (:247-249);
plus the JAX package's layout changes: conv OIHW->HWIO, linear (out,in)->
(in,out), deconv (Cin,Cout,kH,kW)->(kH,kW,Cin,Cout).

``import_chainer_npz``: a reference ``snapshot_model.npz`` -> the tree
(pure layout transposes; coordinates are already y-first).

``import_imagenet_npz``: a chainer ``ResNet50Layers``/``ResNet101Layers``
ImageNet-classification npz -> backbone + head initialization, replicating
``pretrained_model='auto'`` (reference resnet_extractor.py:95-124 +
mask_rcnn_resnet.py:152-166): BGR->RGB conv1 flip, BN folded to affine,
res5 copied into the RoI head; RPN and box/mask branches keep their
freshly-initialized values.

Every importer returns the JAX package's layout (HWIO convs, numpy
arrays); ``models/api.py::resolve_pretrained_params`` turns it into the
port's tensors through the parameter bridge (``utils/checkpoint.py``).
"""

from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np

from mask_rcnn_tpu_torch.models.resnet import RESNET_N_BLOCKS

# Detectron mean (written into params.yaml by the reference converter,
# convert_caffe2_to_chainer.py:287-303).
DETECTRON_MEAN = (122.7717, 115.9465, 102.9801)

_LOC_REORDER = [1, 0, 3, 2]  # (x, y, w, h) -> (y, x, h, w)


def _conv(w):
    """caffe2 OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _loc_channel_reorder(n_groups):
    idx = np.arange(n_groups * 4).reshape(n_groups, 4)
    return idx[:, _LOC_REORDER].reshape(-1)


def _block_names(n_blocks):
    return ["a"] + [f"b{i}" for i in range(1, n_blocks)]


def _import_bottleneck(blobs, prefix, has_proj):
    branch = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c"}
    p = {}
    for ours, theirs in branch.items():
        p[ours] = {"W": _conv(blobs[f"{prefix}_{theirs}_w"])}
        bn = ours.replace("conv", "bn")
        p[bn] = {
            "scale": blobs[f"{prefix}_{theirs}_bn_s"].astype(np.float32),
            "bias": blobs[f"{prefix}_{theirs}_bn_b"].astype(np.float32),
        }
    if has_proj:
        p["conv4"] = {"W": _conv(blobs[f"{prefix}_branch1_w"])}
        p["bn4"] = {
            "scale": blobs[f"{prefix}_branch1_bn_s"].astype(np.float32),
            "bias": blobs[f"{prefix}_branch1_bn_b"].astype(np.float32),
        }
    return p


def _import_stage(blobs, stage_idx, n_blocks):
    out = {}
    for bi, name in enumerate(_block_names(n_blocks)):
        out[name] = _import_bottleneck(
            blobs, f"res{stage_idx}_{bi}", has_proj=(bi == 0)
        )
    return out


def import_detectron_pkl(path: str, n_fg_class: int = 80,
                         n_layers: int = 50) -> Dict:
    """Load a Detectron pkl and return the full param tree."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data)

    blocks = RESNET_N_BLOCKS[n_layers]
    n_class = n_fg_class + 1

    conv1 = _conv(blobs["conv1_w"])  # (7, 7, 3, 64), BGR input order
    conv1 = conv1[:, :, ::-1, :].copy()  # BGR -> RGB

    # The reference model keeps a conv1 bias (converter :48 copies conv1_b);
    # our conv1 is bias-free, so fold it into the bn1 affine exactly:
    # scale*(conv+b)+bias == scale*conv + (bias + scale*b).
    bn1_scale = blobs["res_conv1_bn_s"].astype(np.float32)
    bn1_bias = blobs["res_conv1_bn_b"].astype(np.float32)
    conv1_b = blobs.get("conv1_b")
    if conv1_b is not None:
        bn1_bias = bn1_bias + bn1_scale * conv1_b.astype(np.float32)

    extractor = {
        "conv1": {"W": conv1},
        "bn1": {"scale": bn1_scale, "bias": bn1_bias},
        "res2": _import_stage(blobs, 2, blocks[0]),
        "res3": _import_stage(blobs, 3, blocks[1]),
        "res4": _import_stage(blobs, 4, blocks[2]),
    }

    # RPN: single-logit-per-anchor sigmoid head, matching ours.
    n_anchor = blobs["rpn_cls_logits_w"].shape[0]
    loc_idx = _loc_channel_reorder(n_anchor)
    rpn = {
        "conv1": {
            "W": _conv(blobs["conv_rpn_w"]),
            "b": blobs["conv_rpn_b"].astype(np.float32),
        },
        "score": {
            "W": _conv(blobs["rpn_cls_logits_w"]),
            "b": blobs["rpn_cls_logits_b"].astype(np.float32),
        },
        "loc": {
            "W": _conv(blobs["rpn_bbox_pred_w"])[:, :, :, loc_idx],
            "b": blobs["rpn_bbox_pred_b"].astype(np.float32)[loc_idx],
        },
    }

    cls_idx = _loc_channel_reorder(n_class)
    deconv_w = blobs["conv5_mask_w"]  # (2048, 256, 2, 2)
    mask_w = blobs["mask_fcn_logits_w"]  # (n_fg+1, 256, 1, 1)
    head = {
        "res5": _import_stage(blobs, 5, blocks[3]),
        "cls_loc": {
            "W": np.ascontiguousarray(
                blobs["bbox_pred_w"].T[:, cls_idx]
            ).astype(np.float32),
            "b": blobs["bbox_pred_b"].astype(np.float32)[cls_idx],
        },
        "score": {
            "W": np.ascontiguousarray(blobs["cls_score_w"].T).astype(
                np.float32
            ),
            "b": blobs["cls_score_b"].astype(np.float32),
        },
        "deconv6": {
            "W": np.ascontiguousarray(
                np.transpose(deconv_w, (2, 3, 0, 1))
            ).astype(np.float32),
            "b": blobs["conv5_mask_b"].astype(np.float32),
        },
        "mask": {
            # drop the background channel (converter :247-249)
            "W": _conv(mask_w[1:]),
            "b": blobs["mask_fcn_logits_b"].astype(np.float32)[1:],
        },
    }
    return {"extractor": extractor, "rpn": rpn, "head": head}


IMAGENET_NPZ_SOURCES = {
    # Google Drive ids + md5s the reference auto-downloads
    # (resnet_extractor.py:104-107, 121-124).
    50: ("https://drive.google.com/uc?id="
         "1hSGnWZX_kjEWlfvi0fCHc8sczHio0i-t",
         "841b996a74049800cf0749ac97ab7eba",
         "ResNet-50-model.npz"),
    101: ("https://drive.google.com/uc?id="
          "1c-wtuSDWmBCUTfNKLrQAIjrBMNMW4b7q",
          "2220786332e361fd7f956d9bf2f9d328",
          "ResNet-101-model.npz"),
}


def import_imagenet_npz(path: str, like: Dict, n_layers: int = 50) -> Dict:
    """chainer ``ResNet{50,101}Layers`` ImageNet npz -> full param tree.

    The npz schema is chainer's caffe-converted classification ResNet:
    ``conv1/W``, ``conv1/b``, ``bn1/{gamma,beta,avg_mean,avg_var}``,
    ``res2/a/conv1/W``, ``res2/a/bn1/...`` ... ``res5/b2/...`` (+ ``fc6``,
    unused). Replicates the reference 'auto' path exactly:

      * conv1 weights are caffe-BGR; flipped to RGB
        (resnet_extractor.py:53-56);
      * every BatchNorm folds into a frozen affine with eps=1e-5
        (``_get_affine_from_bn``, resnet_extractor.py:16-29);
      * conv1's bias (our conv1 is bias-free) folds into bn1's affine;
      * res5 is copied into the RoI head (``_copy_persistent_chain``,
        mask_rcnn_resnet.py:152-166);
      * rpn / cls_loc / score / deconv6 / mask keep their values from
        ``like`` (the initializer-created tree).
    """
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def conv(key):
        return np.ascontiguousarray(
            np.transpose(flat[key], (2, 3, 1, 0))
        ).astype(np.float32)

    def affine_from_bn(key):
        # float32 throughout, matching the reference's on-device fold
        gamma = flat[f"{key}/gamma"].astype(np.float32)
        beta = flat[f"{key}/beta"].astype(np.float32)
        mean = flat[f"{key}/avg_mean"].astype(np.float32)
        var = flat[f"{key}/avg_var"].astype(np.float32)
        scale = gamma / np.sqrt(var + np.float32(1e-5))
        return {"scale": scale, "bias": beta - mean * scale}

    def bottleneck(prefix, has_proj):
        p = {}
        for i in (1, 2, 3):
            p[f"conv{i}"] = {"W": conv(f"{prefix}/conv{i}/W")}
            p[f"bn{i}"] = affine_from_bn(f"{prefix}/bn{i}")
        if has_proj:
            p["conv4"] = {"W": conv(f"{prefix}/conv4/W")}
            p["bn4"] = affine_from_bn(f"{prefix}/bn4")
        return p

    def stage(prefix, n_blocks):
        return {
            name: bottleneck(f"{prefix}/{name}", name == "a")
            for name in _block_names(n_blocks)
        }

    blocks = RESNET_N_BLOCKS[n_layers]
    conv1 = conv("conv1/W")[:, :, ::-1, :].copy()  # BGR -> RGB
    bn1 = affine_from_bn("bn1")
    if "conv1/b" in flat:
        bn1["bias"] = bn1["bias"] + bn1["scale"] * flat["conv1/b"].astype(
            np.float32
        )
    extractor = {
        "conv1": {"W": conv1},
        "bn1": bn1,
        "res2": stage("res2", blocks[0]),
        "res3": stage("res3", blocks[1]),
        "res4": stage("res4", blocks[2]),
    }
    head = dict(like["head"])
    head["res5"] = stage("res5", blocks[3])
    return {"extractor": extractor, "rpn": like["rpn"], "head": head}


def is_chainer_snapshot(path: str) -> bool:
    """Sniff whether an npz is a reference ``snapshot_model.npz``.

    The reference stores AffineChannel params as ``extractor/bn1/W``/``b``
    (links/affine_channel_2d.py); both packages store them as
    ``extractor/bn1/scale``/``bias``. The key is unambiguous — a native
    checkpoint never contains ``extractor/bn1/W``. Reads only the zip
    directory, so sniffing every ``--pretrained-model`` path (native
    snapshots included) costs no array decompression. Anything that is not
    a readable zip (a directory, a .npy, a gzip'd file) is simply not a
    chainer snapshot — the caller's own loader then produces the
    format diagnostic."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            return "extractor/bn1/W.npy" in zf.namelist()
    except (OSError, zipfile.BadZipFile):
        return False


def export_chainer_npz(params, path: str, n_layers: int = 50) -> None:
    """A param tree (the JAX package's layout) -> a reference-layout
    ``snapshot_model.npz``.

    Inverse of :func:`import_chainer_npz` (layout transposes only): conv
    HWIO -> OIHW, linear (in, out) -> (out, in), deconv (kH, kW, I, O) ->
    (I, O, kH, kW), affine scale/bias -> W/b. Lets a user migrate a model
    trained here back to the reference (models/mask_rcnn_resnet.py:115-116
    loads this schema), and is the fixture generator for snapshot-import
    tests. Note: our conv1 has no bias (folded into bn1 at import), so the
    exported snapshot carries none; the reference loads partial npz fine.
    """
    flat: Dict[str, np.ndarray] = {}

    def put_conv(key, w):
        flat[key + "/W"] = np.ascontiguousarray(
            np.transpose(np.asarray(w), (3, 2, 0, 1))
        )

    def put_affine(key, p):
        flat[key + "/W"] = np.asarray(p["scale"])
        flat[key + "/b"] = np.asarray(p["bias"])

    def put_block(prefix, bp, has_proj):
        for i in (1, 2, 3):
            put_conv(f"{prefix}/conv{i}", bp[f"conv{i}"]["W"])
            put_affine(f"{prefix}/bn{i}", bp[f"bn{i}"])
        if has_proj:
            put_conv(f"{prefix}/conv4", bp["conv4"]["W"])
            put_affine(f"{prefix}/bn4", bp["bn4"])

    def put_stage(prefix, sp, n_blocks):
        names = _block_names(n_blocks)
        if set(sp) != set(names):
            raise ValueError(
                f"{prefix}: param tree has blocks {sorted(sp)} but "
                f"n_layers={n_layers} expects {names} — pass the n_layers "
                "the tree was built with, or the snapshot would be "
                "silently truncated"
            )
        for name in names:
            put_block(f"{prefix}/{name}", sp[name], name == "a")

    blocks = RESNET_N_BLOCKS[n_layers]
    e = params["extractor"]
    put_conv("extractor/conv1", e["conv1"]["W"])
    put_affine("extractor/bn1", e["bn1"])
    for si, stage in enumerate(["res2", "res3", "res4"]):
        put_stage(f"extractor/{stage}", e[stage], blocks[si])
    for part in ["conv1", "score", "loc"]:
        put_conv(f"rpn/{part}", params["rpn"][part]["W"])
        flat[f"rpn/{part}/b"] = np.asarray(params["rpn"][part]["b"])
    h = params["head"]
    put_stage("head/res5", h["res5"], blocks[3])
    for lin in ["cls_loc", "score"]:
        flat[f"head/{lin}/W"] = np.ascontiguousarray(
            np.asarray(h[lin]["W"]).T
        )
        flat[f"head/{lin}/b"] = np.asarray(h[lin]["b"])
    flat["head/deconv6/W"] = np.ascontiguousarray(
        np.transpose(np.asarray(h["deconv6"]["W"]), (2, 3, 0, 1))
    )
    flat["head/deconv6/b"] = np.asarray(h["deconv6"]["b"])
    put_conv("head/mask", h["mask"]["W"])
    flat["head/mask/b"] = np.asarray(h["mask"]["b"])
    np.savez(path, **flat)


def import_chainer_npz(path: str, n_layers: int = 50) -> Dict:
    """Reference snapshot_model.npz -> our param tree (layout changes only).

    chainer layouts: conv W (O, I, kH, kW); Linear W (out, in); Deconv W
    (I, O, kH, kW); AffineChannel W/b -> scale/bias.

    Raises ValueError when the snapshot's depth does not match
    ``n_layers`` — both directions: a missing key (snapshot shallower
    than requested) and leftover stage blocks (snapshot deeper than
    requested, which would otherwise load a truncated backbone that
    passes structural checks and predicts garbage).
    """
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    consumed = set()

    def take(k):
        if k not in flat:
            raise ValueError(
                f"snapshot {path} has no array {k!r} — it is not a "
                f"resnet{n_layers} snapshot (pass the matching n_layers)"
            )
        consumed.add(k)
        return flat[k]

    def conv(k):
        return np.ascontiguousarray(
            np.transpose(take(k), (2, 3, 1, 0))
        ).astype(np.float32)

    def affine(prefix):
        return {
            "scale": take(f"{prefix}/W").astype(np.float32),
            "bias": take(f"{prefix}/b").astype(np.float32),
        }

    def bottleneck(prefix, has_proj):
        p = {}
        for i in (1, 2, 3):
            p[f"conv{i}"] = {"W": conv(f"{prefix}/conv{i}/W")}
            p[f"bn{i}"] = affine(f"{prefix}/bn{i}")
        if has_proj:
            p["conv4"] = {"W": conv(f"{prefix}/conv4/W")}
            p["bn4"] = affine(f"{prefix}/bn4")
        return p

    def stage(prefix, n_blocks):
        return {
            name: bottleneck(f"{prefix}/{name}", name == "a")
            for name in _block_names(n_blocks)
        }

    blocks = RESNET_N_BLOCKS[n_layers]
    # Fold the snapshot's conv1 bias (extractor/conv1/b) into bn1, exactly
    # (see import_detectron_pkl); our conv1 carries no bias parameter.
    bn1 = affine("extractor/bn1")
    if "extractor/conv1/b" in flat:
        bn1["bias"] = bn1["bias"] + bn1["scale"] * take(
            "extractor/conv1/b"
        ).astype(np.float32)
    extractor = {
        "conv1": {"W": conv("extractor/conv1/W")},
        "bn1": bn1,
        "res2": stage("extractor/res2", blocks[0]),
        "res3": stage("extractor/res3", blocks[1]),
        "res4": stage("extractor/res4", blocks[2]),
    }
    rpn = {
        "conv1": {
            "W": conv("rpn/conv1/W"),
            "b": take("rpn/conv1/b").astype(np.float32),
        },
        "score": {
            "W": conv("rpn/score/W"),
            "b": take("rpn/score/b").astype(np.float32),
        },
        "loc": {
            "W": conv("rpn/loc/W"),
            "b": take("rpn/loc/b").astype(np.float32),
        },
    }
    head = {
        "res5": stage("head/res5", blocks[3]),
        "cls_loc": {
            "W": np.ascontiguousarray(take("head/cls_loc/W").T).astype(
                np.float32
            ),
            "b": take("head/cls_loc/b").astype(np.float32),
        },
        "score": {
            "W": np.ascontiguousarray(take("head/score/W").T).astype(
                np.float32
            ),
            "b": take("head/score/b").astype(np.float32),
        },
        "deconv6": {
            "W": np.ascontiguousarray(
                np.transpose(take("head/deconv6/W"), (2, 3, 0, 1))
            ).astype(np.float32),
            "b": take("head/deconv6/b").astype(np.float32),
        },
        "mask": {
            "W": conv("head/mask/W"),
            "b": take("head/mask/b").astype(np.float32),
        },
    }
    # Leftover stage blocks mean the snapshot is deeper than n_layers
    # (e.g. a resnet101 snapshot loaded as resnet50): the truncated tree
    # would pass structural checks and silently predict garbage. Other
    # leftovers (persistents a future chainer might serialize) are benign.
    leftover = {
        k for k in set(flat) - consumed
        if re.search(r"/(conv|bn)\d/", k)
    }
    if leftover:
        raise ValueError(
            f"snapshot {path} has {len(leftover)} stage arrays beyond "
            f"resnet{n_layers} (e.g. {sorted(leftover)[:3]}) — pass the "
            "matching n_layers instead of silently truncating the model"
        )
    return {"extractor": extractor, "rpn": rpn, "head": head}
