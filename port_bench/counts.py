"""The benchmark's own yardstick: the card's published peaks, the FLOPs of
the model's work worked out from the configuration's shapes, and the bytes
that a kernel's roofline floor counts.

FLOPs count what ``torch.utils.flop_counter.FlopCounterMode`` counts on the
plain reference (``port_bench/reference``): 2 a multiply-accumulate of
every convolution (its padded border taps included, at every output
position) and matrix product, and of each backward convolution or product
that autograd needs; elementwise work, pooling, RoIAlign, NMS and the
losses count nothing. The count depends only on the configuration and the
traffic's sizes, never on what the program launches, so a change that
fuses or removes an operation of the program leaves it as it is.

Bytes of a kernel's floor: each input read once and each output written
once, at the call's shapes, in the configuration's compute type.
"""

from __future__ import annotations

# Card name (torch.cuda.get_device_name) -> its published peaks: NVIDIA's
# H100 SXM data sheet, dense rates without sparsity, at the 700 W limit.
CARDS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "flops": {"bf16": 989e12, "f32": 67e12}},
}
BYTES = {"bfloat16": 2, "float32": 4}


def conv(n, h_out, w_out, c_in, c_out, k):
    """FLOPs of one convolution's forward: 2 a MAC at every output."""
    return 2 * n * h_out * w_out * c_in * c_out * k * k


def _out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def _block_convs(h, w, c_in, mid, c_out, stride, projection):
    """[(flops of one image's forward, input wants a gradient)] of a caffe
    bottleneck at input (h, w): the stride on conv1 and conv4. The first
    entries read the block's input."""
    ho, wo = _out(h, 1, stride, 0), _out(w, 1, stride, 0)
    convs = [(conv(1, ho, wo, c_in, mid, 1), "input"),
             (conv(1, ho, wo, mid, mid, 3), "inner"),
             (conv(1, ho, wo, mid, c_out, 1), "inner")]
    if projection:
        convs.append((conv(1, ho, wo, c_in, c_out, 1), "input"))
    return convs, ho, wo


STAGES = (("res2", 64, 64, 256, 1), ("res3", 256, 128, 512, 2),
          ("res4", 512, 256, 1024, 2), ("res5", 1024, 512, 2048, 2))
BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _stage(h, w, stage, n_blocks, stride=None):
    name, c_in, mid, c_out, s = next(x for x in STAGES if x[0] == stage)
    s = s if stride is None else stride
    convs, h, w = _block_convs(h, w, c_in, mid, c_out, s, True)
    for _ in range(1, n_blocks):
        more, h, w = _block_convs(h, w, c_out, mid, c_out, 1, False)
        convs += more
    return convs, h, w


def backbone_convs(model, h, w):
    """(per-stage lists of (flops, kind)) of one image at the padded
    (h, w): the stem, res2, res3, res4; and the C4 feature size."""
    blocks = BLOCKS[model["n_layers"]]
    h2, w2 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    stem = [(conv(1, h2, w2, 3, 64, 7), "input")]
    h4, w4 = _out(h2, 3, 2, 1), _out(w2, 3, 2, 1)
    res2, h4, w4 = _stage(h4, w4, "res2", blocks[0])
    res3, h8, w8 = _stage(h4, w4, "res3", blocks[1])
    res4, h16, w16 = _stage(h8, w8, "res4", blocks[2])
    return {"stem": stem, "res2": res2, "res3": res3, "res4": res4}, (h16,
                                                                      w16)


def rpn_flops(model, hf, wf):
    a = len(model["ratios"]) * len(model["anchor_scales"])
    return (conv(1, hf, wf, 1024, model["rpn_hidden"], 3)
            + conv(1, hf, wf, model["rpn_hidden"], 5 * a, 1))


def res5_flops(model):
    """One roi's res5 at the pooled 7x7 (stride 1 with the 14-bin
    RoIAlign of ``roi_size`` 14)."""
    s5 = model["roi_size"] // 7
    size = 7 if s5 > 1 else model["roi_size"]
    convs, _, _ = _stage(size, size, "res5", 3, stride=1 if s5 > 1 else 2)
    return sum(f for f, _ in convs), size


def box_flops(model):
    n_class = model["n_fg_class"] + 1
    return 2 * 2048 * 5 * n_class  # cls_loc (4 n_class) and score


def mask_flops(model):
    _, size = res5_flops(model)
    deconv = 2 * size * size * 2048 * 256 * 4
    return deconv + conv(1, 2 * size, 2 * size, 256, model["n_fg_class"], 1)


def predict_flops(model, h, w, n_images, n_dets):
    """A predict step's FLOPs: ``n_images`` at the padded (h, w), the box
    head on the test proposals of each, and res5 with the mask branch on
    ``n_dets`` detections in all."""
    convs, (hf, wf) = backbone_convs(model, h, w)
    per_image = (sum(f for stage in convs.values() for f, _ in stage)
                 + rpn_flops(model, hf, wf))
    rois = model["proposal"]["n_test_post_nms"]
    res5, _ = res5_flops(model)
    return (n_images * (per_image + rois * (res5 + box_flops(model)))
            + n_dets * (res5 + mask_flops(model)))


def train_flops(model, train, h, w, n_images):
    """A train step's FLOPs, forward and backward, at the padded (h, w):
    conv1, bn1 and res2 frozen and cut from the gradient, so res3's first
    convolutions compute no input gradient; every other convolution and
    product computes its weight's gradient and its input's (each as much
    as its forward)."""
    convs, (hf, wf) = backbone_convs(model, h, w)
    fwd = sum(f for stage in convs.values() for f, _ in stage)
    bwd = 0
    for name in ("res3", "res4"):
        for i, (f, kind) in enumerate(convs[name]):
            first_block = i < 4
            bwd += f if (name == "res3" and first_block
                         and kind == "input") else 2 * f
    rpn = rpn_flops(model, hf, wf)
    pt = train["proposal_target"]
    rois = pt["n_sample"]
    pos = min(int(round(rois * pt["pos_ratio"])), rois)
    res5, _ = res5_flops(model)
    head = rois * (res5 + box_flops(model)) + pos * mask_flops(model)
    return n_images * (fwd + bwd + 3 * rpn + 3 * head)


def roi_align_bytes(n, hf, wf, rois, model, dtype):
    """K1's floor: the features read once, the rois read once, the pooled
    bins (7x7 of the 14-bin grid) written once."""
    b = BYTES[dtype]
    _, size = res5_flops(model)
    return (n * hf * wf * 1024 * b + n * rois * 16
            + n * rois * size * size * 1024 * b)


def roi_align_bwd_bytes(n, hf, wf, rois, model, dtype):
    """K7's floor: the pooled gradient read once, the rois read once, the
    features' gradient written once."""
    return roi_align_bytes(n, hf, wf, rois, model, dtype)


def floor_seconds(n_bytes, flops, peaks, kind="bf16"):
    return max(n_bytes / peaks["bytes_per_s"], flops / peaks["flops"][kind])
