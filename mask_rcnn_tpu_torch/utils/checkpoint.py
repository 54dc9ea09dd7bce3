"""Parameter bridge between the JAX package's layout and the port's, the
port of ``mask_rcnn_tpu/utils/checkpoint.py``.

Both packages keep parameters as nested dicts under the same slash-joined
names (``extractor/res2/a/conv1/W``); the npz that the JAX package's
``save_params`` writes is that flat mapping in its layouts:

=================  =====================  =========================
parameter          JAX package (numpy)    port (torch)
=================  =====================  =========================
conv ``W``         HWIO                   OIHW (``F.conv2d``)
``deconv6/W``      (2, 2, C, O)           (C, O, 2, 2)
                                          (``F.conv_transpose2d``)
linear ``W``       (in, out)              (in, out), ``x @ W + b``
scale, bias, b     (C,)                   (C,)
=================  =====================  =========================
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_params(params, prefix="") -> Dict[str, object]:
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def unflatten_params(flat: Dict[str, object]):
    tree: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _to_port(path: str, a: np.ndarray) -> np.ndarray:
    if a.ndim != 4:
        return a
    if path.endswith("deconv6/W"):
        return a.transpose(2, 3, 0, 1)
    return a.transpose(3, 2, 0, 1)


def _to_jax(path: str, a: np.ndarray) -> np.ndarray:
    if a.ndim != 4:
        return a
    if path.endswith("deconv6/W"):
        return a.transpose(2, 3, 0, 1)
    return a.transpose(2, 3, 1, 0)


def params_from_numpy(flat: Dict[str, np.ndarray], device="cpu"):
    """The JAX package's parameters as a flat mapping of numpy arrays (its
    ``flatten_params``) -> the port's nested dict of torch tensors."""
    return unflatten_params({
        k: torch.from_numpy(np.array(_to_port(k, np.asarray(v)),
                                     order="C")).to(device)
        for k, v in flat.items()
    })


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's parameters -> the JAX package's flat numpy layout."""
    return {
        k: np.ascontiguousarray(_to_jax(k, v.detach().cpu().numpy()))
        for k, v in flatten_params(params).items()
    }


def save_params(path: str, params) -> None:
    """Write the npz the JAX package's ``load_params`` reads."""
    np.savez(path, **params_to_numpy(params))


def load_params(path: str, device="cpu"):
    """Read an npz written by either package's ``save_params``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, device)
