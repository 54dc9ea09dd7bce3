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

A train state crosses the same way: the momentum trace of the JAX
package's masked optax chain has the params' names and layouts for the
trainable leaves (``train_state_from_numpy`` / ``train_state_to_numpy``).

``save_train_state`` / ``restore_train_state`` checkpoint the port's
``TrainState`` for resume: one npz, ``params/<name>`` and
``momentum/<name>`` in the bridge's (JAX) layouts plus ``step``, written
atomically (a temporary file, then ``os.replace``).
"""

from __future__ import annotations

import os
import os.path as osp
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


def conform_params(tree, like, device=None):
    """Check that ``tree`` has exactly ``like``'s parameter names and
    shapes, and cast its leaves to ``like``'s dtypes and to ``device``
    (default: each ``like`` leaf's own; the JAX package's
    ``conform_params``). ``like`` may live on the meta device."""
    flat = flatten_params(tree)
    want = flatten_params(like)
    missing = set(want) - set(flat)
    extra = set(flat) - set(want)
    if missing or extra:
        raise ValueError(
            f"param tree mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}"
        )
    for k, v in want.items():
        if tuple(flat[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(flat[k].shape)} vs {tuple(v.shape)}")
    return unflatten_params({
        k: flat[k].to(device=device or v.device, dtype=v.dtype)
        for k, v in want.items()
    })


def load_params(path: str, device="cpu", like=None):
    """Read an npz written by either package's ``save_params`` onto
    ``device``. With ``like`` (a params tree, on any device or the meta
    device) the names and shapes are checked against it and the leaves
    take its dtypes."""
    try:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
    except Exception as e:
        raise ValueError(
            f"could not read '{path}' as a parameter npz: {e}. The port "
            "loads the npz either package's save_params writes."
        ) from e
    params = params_from_numpy(flat, device)
    if like is None:
        return params
    return conform_params(params, like, torch.device(device))


def train_state_from_numpy(params_flat: Dict[str, np.ndarray],
                           momentum_flat: Dict[str, np.ndarray], step: int,
                           device="cpu"):
    """A JAX ``TrainState`` as flat numpy mappings -> the port's
    ``TrainState``. ``momentum_flat`` is the masked chain's trace (the
    trainable leaves, under the params' names and layouts) and ``step``
    its schedule count. The trainable leaves require grad."""
    from mask_rcnn_tpu_torch.engine.trainer import TrainState, is_trainable

    params = params_from_numpy(params_flat, device)
    for k, t in flatten_params(params).items():
        t.requires_grad_(is_trainable(k))
    return TrainState(params, params_from_numpy(momentum_flat, device),
                      int(step))


def train_state_to_numpy(state):
    """The port's ``TrainState`` -> (params_flat, momentum_flat, step) in
    the JAX package's layouts."""
    return (params_to_numpy(state.params), params_to_numpy(state.momentum),
            int(state.step))


def save_train_state(directory: str, state) -> None:
    """Checkpoint the port's ``TrainState`` (params, momentum, step) to
    ``directory/state.npz``, atomically."""
    params, momentum, step = train_state_to_numpy(state)
    arrays = {f"params/{k}": v for k, v in params.items()}
    arrays.update({f"momentum/{k}": v for k, v in momentum.items()})
    arrays["step"] = np.asarray(step, np.int64)
    os.makedirs(directory, exist_ok=True)
    tmp = osp.join(directory, "state.tmp.npz")  # savez keeps the suffix
    np.savez(tmp, **arrays)
    os.replace(tmp, osp.join(directory, "state.npz"))


def restore_train_state(directory: str, like):
    """Read a :func:`save_train_state` checkpoint. ``like`` (a
    ``TrainState``) gives the names, shapes, dtypes and device that the
    restored params and momentum must have; the restored trainable leaves
    require grad as ``like``'s do."""
    from mask_rcnn_tpu_torch.engine.trainer import TrainState

    with np.load(osp.join(directory, "state.npz")) as data:
        flat = {k: data[k] for k in data.files}
    parts = {"params": {}, "momentum": {}}
    for k, v in flat.items():
        head, _, name = k.partition("/")
        if head in parts:
            parts[head][name] = v
    params = conform_params(params_from_numpy(parts["params"]), like.params)
    momentum = conform_params(params_from_numpy(parts["momentum"]),
                              like.momentum)
    want = flatten_params(like.params)
    for k, t in flatten_params(params).items():
        t.requires_grad_(want[k].requires_grad)
    return TrainState(params, momentum, int(flat["step"]))
