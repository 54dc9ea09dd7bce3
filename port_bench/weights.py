"""Seeded weights, made on the device in one draw: the nested layout that
the port's ``MaskRCNNResNet.from_config`` and ``make_train_step`` take
(OIHW convolutions, frozen BatchNorm as ``scale`` and ``bias``), in the
draw order and shapes of the architecture's ``layout``, handed as they are
to the plain reference.

The distributions are the port's initializer's (he_normal convolutions,
the stem's affine at 0.5, each residual branch's last affine at 0.1, the
RPN at 0.01, ``cls_loc`` at 0.001) except where the configuration's
``weights`` group sets a standard deviation: random weights at those scales
would score every class at about 1/81, below the 0.05 threshold, and the
serving cells would return no detection to paste.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.counts import STAGES

RESIDUAL_SCALE = 0.1


def _bottleneck(spec, path, c_in, mid, c_out, projection):
    def he(k, ci, co):
        return ("normal", (co, ci, k, k), (2.0 / (k * k * ci)) ** 0.5)

    spec += [(path + "/conv1/W", he(1, c_in, mid)),
             (path + "/bn1", ("affine", mid, 1.0)),
             (path + "/conv2/W", he(3, mid, mid)),
             (path + "/bn2", ("affine", mid, 1.0)),
             (path + "/conv3/W", he(1, mid, c_out)),
             (path + "/bn3", ("affine", c_out, RESIDUAL_SCALE))]
    if projection:
        spec += [(path + "/conv4/W", he(1, c_in, c_out)),
                 (path + "/bn4", ("affine", c_out, RESIDUAL_SCALE))]


def _stage(spec, path, stage, n_blocks):
    _, c_in, mid, c_out, _ = next(x for x in STAGES if x[0] == stage)
    _bottleneck(spec, f"{path}/{stage}/a", c_in, mid, c_out, True)
    for i in range(1, n_blocks):
        _bottleneck(spec, f"{path}/{stage}/b{i}", c_out, mid, c_out, False)


def generator(seed, device, stream=0):
    """A generator on ``device`` seeded from (seed, stream): any whole
    seed, however large."""
    state = np.random.SeedSequence([int(seed) % 2 ** 128, stream])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]) >> 1)


def of_config(arch, config, device):
    """The configuration's weights: drawn from its ``weights.seed``, the
    same in every run. They decide which proposals win, so how large the
    detections are and how long their paste takes: weights drawn from the
    run's seed moved the stream cell's rate by half from seed to seed."""
    return make(arch, config["model"], config["weights"],
                config["weights"]["seed"], device)


def make(arch, model, stds, seed, device):
    """The float32 weights of ``seed`` in ``arch.layout``'s order: one
    normal draw on the device for every weight, scaled leaf by leaf."""
    spec = arch.layout(model, stds)
    total = sum(int(np.prod(s)) for _, (kind, s, *_) in spec
                if kind == "normal")
    buf = torch.randn(total, generator=generator(seed, device, 0),
                      device=device)
    params, off = {}, 0
    for path, (kind, shape, *rest) in spec:
        if kind == "normal":
            n = int(np.prod(shape))
            leaves = {"": buf[off:off + n].view(shape) * rest[0]}
            off += n
        elif kind == "zeros":
            leaves = {"": torch.zeros(shape, device=device)}
        else:
            leaves = {"/scale": torch.full((shape,), float(rest[0]),
                                           device=device),
                      "/bias": torch.zeros(shape, device=device)}
        for suffix, t in leaves.items():
            node = params
            keys = (path + suffix).split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
    return params
