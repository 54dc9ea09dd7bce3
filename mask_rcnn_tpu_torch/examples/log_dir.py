"""Rebuild a model from a training log dir, the port of
``examples/demo.py::build_model_from_log_dir`` (shared by the evaluate
drivers): ``params.yaml`` (this framework's ``model_config`` dict, or a
reference log dir's flat serialized argparse namespace, reference
examples/train_common.py:286-288, examples/demo.py:39-76) plus
``snapshot_model.npz``."""

from __future__ import annotations

import os.path as osp

from mask_rcnn_tpu_torch.models import api
from mask_rcnn_tpu_torch.utils.logging import load_params_yaml

DATASET_DEFAULTS = {
    "coco": dict(min_size=800, max_size=1333,
                 anchor_scales=(2, 4, 8, 16, 32), n_fg_class=80),
    "voc": dict(min_size=600, max_size=1000,
                anchor_scales=(4, 8, 16, 32), n_fg_class=20),
}


def build_model_from_log_dir(log_dir: str, device="cuda"):
    """(model, params_yaml) for the log dir's snapshot, on ``device``."""
    params_yaml = load_params_yaml(log_dir)
    mc = dict(params_yaml.get("model_config", {}))
    if not mc:
        # A reference log dir: its params.yaml is the flat serialized
        # argparse namespace. Map the flat keys so a migrating user's
        # reference-trained log dir works unchanged — in particular
        # `model: resnet101` must pick the matching depth or the snapshot
        # import rejects the tree.
        if "model" in params_yaml:
            # exact match, mirroring the reference's
            # int(model.lstrip('resnet')) contract — substring sniffing
            # would silently map an unsupported depth (e.g. resnet152)
            # onto 50/101 and the later snapshot-import failure would
            # point at the wrong cause.
            depths = {"resnet50": 50, "resnet101": 101}
            name = str(params_yaml["model"])
            if name not in depths:
                raise ValueError(
                    f"unsupported model {name!r} in params.yaml; expected "
                    f"one of {sorted(depths)}"
                )
            mc["n_layers"] = depths[name]
        if params_yaml.get("class_names"):
            mc["n_fg_class"] = len(params_yaml["class_names"])
        for key in ("min_size", "max_size", "anchor_scales", "roi_size",
                    "mean"):
            if params_yaml.get(key) is not None:
                mc[key] = params_yaml[key]
        if params_yaml.get("pooling_func"):
            mc["pooling"] = params_yaml["pooling_func"]
    dataset = params_yaml.get("dataset", "coco")
    defaults = DATASET_DEFAULTS.get(dataset, DATASET_DEFAULTS["coco"])
    kwargs = {}
    if mc.get("mean") is not None:
        kwargs["mean"] = tuple(mc["mean"])
    model = api.MaskRCNNResNet(
        n_layers=mc.get("n_layers", 50),
        n_fg_class=mc.get("n_fg_class", defaults["n_fg_class"]),
        min_size=mc.get("min_size", defaults["min_size"]),
        max_size=mc.get("max_size", defaults["max_size"]),
        anchor_scales=tuple(
            mc.get("anchor_scales", defaults["anchor_scales"])
        ),
        roi_size=mc.get("roi_size", 14),
        pooling_func=mc.get("pooling", "align"),
        pretrained_model=osp.join(log_dir, "snapshot_model.npz"),
        device=device,
        **kwargs,
    )
    return model, params_yaml
