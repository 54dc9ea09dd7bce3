"""The benchmark's own yardstick: the card's published peaks, and the
ResNet trunk's building blocks from which each architecture
(``archs/<name>.py``) works out the FLOPs of the model's work from the
configuration's shapes, and the bytes that a kernel's roofline floor
counts.

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


def floor_seconds(n_bytes, flops, peaks, kind="bf16"):
    return max(n_bytes / peaks["bytes_per_s"], flops / peaks["flops"][kind])
