"""Plain float32 Mask R-CNN R-50/101-C4 inference: preparation, backbone,
RPN, proposals, RoIAlign, the C4 head, the decode and the paste.

Tensors are NCHW here; the weights come in the benchmark's nested layout
(``port_bench/weights.py``: OIHW convolutions, frozen BatchNorm as a
per-channel ``scale`` and ``bias``). ``cfg`` is the configuration file's
``model`` group (``port_bench/configs/<name>.json``). Every selection
(top-k, NMS, the decode's per-class choice) is exact greedy arithmetic on
float32, ties to the lower index.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

N_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def full_precision():
    """float32 convolutions and matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8Round(torch.autograd.Function):
    """x rounded to float8 e4m3 at a per-tensor scale (amax to 448); the
    gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float()
        scale = torch.clamp(amax, min=1e-30) / FP8_MAX
        return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class Precision:
    """What the reference computes convolutions and products in: float32
    (the reference), or float8 (the control): operands and results rounded
    to float8, as a program that keeps its activations in float8 rounds
    every layer's input and output."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x):
        return _Fp8Round.apply(x) if self.fp8 else x


FULL = Precision(False)
FP8 = Precision(True)


def conv(x, w, prec, stride=1, pad=0, bias=None):
    return prec.q(F.conv2d(prec.q(x), prec.q(w), bias, stride=stride,
                           padding=pad))


def linear(x, w, b, prec):
    return prec.q(prec.q(x) @ prec.q(w) + b)


def affine(x, p):
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


# ---------------------------------------------------------------------------
# Backbone (caffe bottlenecks: the stride on the 1x1 conv1 and conv4)


def bottleneck(p, x, stride, projection, prec):
    h = F.relu(affine(conv(x, p["conv1"]["W"], prec, stride), p["bn1"]))
    h = F.relu(affine(conv(h, p["conv2"]["W"], prec, 1, 1), p["bn2"]))
    h = affine(conv(h, p["conv3"]["W"], prec), p["bn3"])
    if projection:
        x = affine(conv(x, p["conv4"]["W"], prec, stride), p["bn4"])
    return F.relu(h + x)


def stage(p, x, n_blocks, stride, prec):
    x = bottleneck(p["a"], x, stride, True, prec)
    for i in range(1, n_blocks):
        x = bottleneck(p["b%d" % i], x, 1, False, prec)
    return x


def backbone(p, x, n_layers, prec, train=False):
    """(N, 3, H, W) mean-subtracted images -> (N, 1024, H/16, W/16) C4
    features. ``train`` freezes conv1, bn1 and res2 (no gradient)."""
    blocks = N_BLOCKS[n_layers]
    with torch.no_grad() if train else contextlib.nullcontext():
        h = F.relu(affine(conv(x, p["conv1"]["W"], prec, 2, 3), p["bn1"]))
        h = F.max_pool2d(h, 3, 2, 1)
        h = stage(p["res2"], h, blocks[0], 1, prec)
    h = stage(p["res3"], h, blocks[1], 2, prec)
    return stage(p["res4"], h, blocks[2], 2, prec)


def rpn(p, feats, prec):
    """-> locs (N, H*W*A, 4), scores (N, H*W*A), in (H, W, A) order."""
    n = feats.shape[0]
    h = F.relu(conv(feats, p["conv1"]["W"], prec, 1, 1, p["conv1"]["b"]))
    locs = conv(h, p["loc"]["W"], prec, bias=p["loc"]["b"])
    scores = conv(h, p["score"]["W"], prec, bias=p["score"]["b"])
    return (locs.permute(0, 2, 3, 1).reshape(n, -1, 4),
            scores.permute(0, 2, 3, 1).reshape(n, -1))


# ---------------------------------------------------------------------------
# Boxes and anchors: (y1, x1, y2, x2), locs (dy, dx, dh, dw)


def anchors(cfg, feat_h, feat_w, device):
    """(H*W*A, 4) anchors of base 16, ratio-major, cell-major order."""
    base = []
    for ratio in cfg["ratios"]:
        for scale in cfg["anchor_scales"]:
            h = 16.0 * scale * np.sqrt(ratio)
            w = 16.0 * scale * np.sqrt(1.0 / ratio)
            base.append([8.0 - h / 2.0, 8.0 - w / 2.0, 8.0 + h / 2.0,
                         8.0 + w / 2.0])
    base = np.asarray(base, np.float32)
    stride = cfg["feat_stride"]
    sx, sy = np.meshgrid(np.arange(0, feat_w * stride, stride),
                         np.arange(0, feat_h * stride, stride))
    shift = np.stack((sy.ravel(), sx.ravel(), sy.ravel(), sx.ravel()), 1)
    out = (base[None] + shift[:, None]).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(out).to(device)


def loc2bbox(src, loc):
    h = src[..., 2] - src[..., 0]
    w = src[..., 3] - src[..., 1]
    cy = loc[..., 0] * h + (src[..., 0] + 0.5 * h)
    cx = loc[..., 1] * w + (src[..., 1] + 0.5 * w)
    h = torch.exp(loc[..., 2]) * h
    w = torch.exp(loc[..., 3]) * w
    return torch.stack([cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h,
                        cx + 0.5 * w], dim=-1)


def bbox2loc(src, dst):
    eps = torch.finfo(torch.float32).eps
    h = src[..., 2] - src[..., 0]
    w = src[..., 3] - src[..., 1]
    cy = src[..., 0] + 0.5 * h
    cx = src[..., 1] + 0.5 * w
    bh = dst[..., 2] - dst[..., 0]
    bw = dst[..., 3] - dst[..., 1]
    by = dst[..., 0] + 0.5 * bh
    bx = dst[..., 1] + 0.5 * bw
    h = torch.clamp(h, min=eps)
    w = torch.clamp(w, min=eps)
    return torch.stack([(by - cy) / h, (bx - cx) / w,
                        torch.log(torch.clamp(bh, min=eps) / h),
                        torch.log(torch.clamp(bw, min=eps) / w)], dim=-1)


def bbox_area(b):
    return (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0.0))


def bbox_iou(a, b):
    """(..., N, 4) x (..., K, 4) -> (..., N, K)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    denom = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return torch.where(denom > 0, inter / denom, 0.0)


def clip(b, h, w):
    def c(x, hi):
        return torch.clamp(torch.clamp(x, min=0.0), max=hi)
    return torch.stack([c(b[..., 0], h), c(b[..., 1], w), c(b[..., 2], h),
                        c(b[..., 3], w)], dim=-1)


# ---------------------------------------------------------------------------
# Greedy NMS: keep j iff valid and no kept i < j has IoU(i, j) > thresh


def suppression(a, b, thresh):
    """(I, J) bool ``IoU(a_i, b_j) > thresh`` without a division."""
    ay1, ax1, ay2, ax2 = (a[:, k, None] for k in range(4))
    by1, bx1, by2, bx2 = (b[None, :, k] for k in range(4))
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    inter = ih * iw
    area_a = torch.clamp(ay2 - ay1, min=0.0) * torch.clamp(ax2 - ax1, min=0.0)
    area_b = torch.clamp(by2 - by1, min=0.0) * torch.clamp(bx2 - bx1, min=0.0)
    return inter > thresh * (area_a + area_b - inter)


def nms(boxes, valid, thresh, max_out):
    """Positions kept by greedy NMS over score-sorted ``boxes`` (K, 4),
    at most ``max_out``, in order."""
    sup = suppression(boxes, boxes, thresh).cpu().numpy()
    removed = ~valid.cpu().numpy().copy()
    kept = []
    for i in range(len(removed)):
        if removed[i]:
            continue
        kept.append(i)
        if len(kept) == max_out:
            break
        removed |= sup[i]
    return kept


def sort_desc(x):
    """Stable descending sort (ties to the lower index)."""
    return torch.sort(x, descending=True, stable=True)


def propose(cfg, locs, scores, anchor, img_hw, train=False):
    """One image's proposals: decode, clip, the top pre-NMS scores, NMS
    0.7, padded -> (rois (n_post, 4), valid (n_post,)), and the top
    candidates (rois and scores) before NMS."""
    pc = cfg["proposal"]
    n_pre = pc["n_train_pre_nms" if train else "n_test_pre_nms"]
    n_post = pc["n_train_post_nms" if train else "n_test_post_nms"]
    roi = clip(loc2bbox(anchor, locs.float()), *img_hw)
    ok = ((roi[:, 2] - roi[:, 0] >= pc["min_size"])
          & (roi[:, 3] - roi[:, 1] >= pc["min_size"]))
    s, order = sort_desc(torch.where(ok, scores.float(), -torch.inf))
    k = min(n_pre, len(s))
    top, top_s = roi[order[:k]], s[:k]
    kept = nms(top, torch.isfinite(top_s), pc["nms_thresh"], n_post)
    rois = torch.zeros((n_post, 4), device=roi.device)
    valid = torch.zeros((n_post,), dtype=torch.bool, device=roi.device)
    rois[:len(kept)] = top[kept]
    valid[:len(kept)] = True
    return rois, valid


# ---------------------------------------------------------------------------
# RoIAlign (Detectron): adaptive grid ceil(bin), samples outside [-1, size]
# skipped but counted, low clamp at 0, high clamp at size - 1


def _axis(start, extent, size, out, bin_stride, g):
    """Sample coordinates (R, out, g) along one axis, their validity, and
    each roi's grid."""
    full = out * bin_stride
    bin_ = extent / torch.full_like(extent, full)
    grid = torch.clamp(torch.ceil(bin_), 1, -(-size // full))
    p = torch.arange(out, dtype=torch.float32, device=start.device)
    s = torch.arange(g, dtype=torch.float32, device=start.device)
    c = (start[:, None, None] + (p * bin_stride)[:, None] * bin_[:, None, None]
         + (s + 0.5) * (bin_ / grid)[:, None, None])
    valid = (s < grid[:, None, None]) & (c >= -1.0) & (c <= size)
    c = torch.clamp(c, min=0.0)
    c = torch.where(torch.floor(c) >= size - 1, float(size - 1), c)
    return c, valid, grid


def roi_align(feat, rois, out, scale, bin_stride, budget=2 ** 27):
    """feat (1, C, H, W), rois (R, 4) in image coordinates -> (R, C, out,
    out): each bin the mean of its bilinear samples (``grid_sample``)."""
    _, c, h, w = feat.shape
    r = rois.float() * scale
    ey = torch.clamp(r[:, 2] - r[:, 0], min=1.0)
    ex = torch.clamp(r[:, 3] - r[:, 1], min=1.0)
    full = out * bin_stride
    g_all = torch.maximum(
        torch.clamp(torch.ceil(ey / full), 1, -(-h // full)),
        torch.clamp(torch.ceil(ex / full), 1, -(-w // full)))
    outs = []
    start = 0
    while start < len(r):
        g = int(g_all[start:start + 64].max())
        n = max(1, min(len(r) - start, budget // (c * out * out * g * g)))
        g = int(g_all[start:start + n].max())
        rr = r[start:start + n]
        cy, vy, gy = _axis(rr[:, 0], ey[start:start + n], h, out,
                           bin_stride, g)
        cx, vx, gx = _axis(rr[:, 1], ex[start:start + n], w, out,
                           bin_stride, g)
        # normalised (x, y) for align_corners=True; a skipped sample goes
        # far outside, where the zero padding reads nothing
        ny = cy * (2.0 / max(h - 1, 1)) - 1.0
        nx = cx * (2.0 / max(w - 1, 1)) - 1.0
        ok = vy[:, :, :, None, None] & vx[:, None, None, :, :]
        shape = ok.shape  # (n, out, g, out, g)
        yy = torch.where(ok, ny[:, :, :, None, None].expand(shape), -9.0)
        xx = torch.where(ok, nx[:, None, None, :, :].expand(shape), -9.0)
        grid = torch.stack([xx, yy], dim=-1).reshape(1, n * out * g,
                                                     out * g, 2)
        s = F.grid_sample(feat, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        s = s.reshape(c, n, out, g, out, g).sum(dim=(3, 5))
        s = s / (gy * gx)[None, :, None, None]
        outs.append(s.permute(1, 0, 2, 3))
        start += n
    if not outs:
        return feat.new_zeros((0, c, out, out))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# The C4 head: RoIAlign at 7 bins of a 14-bin grid, res5 at stride 1, the
# 7x7 mean, the box and class layers, and the mask branch


def head(p, cfg, feat, rois, prec, bbox=True, mask=False, mask_rows=None):
    """feat (1, C, H, W), rois (R, 4) -> dict of cls_loc (R, 4 n_class),
    score (R, n_class), mask (R or len(mask_rows), n_fg, 14, 14) logits."""
    s5 = cfg["roi_size"] // 7
    pool = roi_align(feat, rois, 7, 1.0 / cfg["feat_stride"], s5)
    h = stage(p["res5"], pool, 3, 1, prec)
    out = {}
    if bbox:
        p5 = h.mean(dim=(2, 3))
        out["cls_loc"] = linear(p5, p["cls_loc"]["W"], p["cls_loc"]["b"], prec)
        out["score"] = linear(p5, p["score"]["W"], p["score"]["b"], prec)
    if mask:
        if mask_rows is not None:
            h = h[mask_rows]
        d = F.relu(prec.q(F.conv_transpose2d(
            prec.q(h), prec.q(p["deconv6"]["W"]), p["deconv6"]["b"],
            stride=2)))
        out["mask"] = conv(d, p["mask"]["W"], prec, bias=p["mask"]["b"])
    return out


def head_chunked(p, cfg, feat, rois, prec, chunk=1024, **kw):
    outs = [head(p, cfg, feat, rois[i:i + chunk], prec, **kw)
            for i in range(0, len(rois), chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def class_boxes(cfg, rois, cls_loc, score, size, scale):
    """(probabilities (R, n_class), every class's box (R, n_class, 4) in
    original-image coordinates, clipped)."""
    n_class = cfg["n_fg_class"] + 1
    dev = rois.device
    prob = torch.softmax(score.float(), dim=-1)
    mean = torch.tensor(cfg["loc_normalize_mean"] * n_class, device=dev)
    std = torch.tensor(cfg["loc_normalize_std"] * n_class, device=dev)
    loc = (cls_loc.float() * std + mean).reshape(-1, n_class, 4)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    roi_img = rois / scale_t
    box = loc2bbox(roi_img[:, None, :].expand_as(loc), loc)
    hi = torch.tensor([size[0], size[1]] * 2, dtype=torch.float32,
                      device=dev)
    return prob, torch.minimum(torch.clamp(box, min=0.0), hi)


def select(cfg, prob, box, valid):
    """The decode's selection: per foreground class the top
    ``nms_topk_per_class`` valid rows above ``score_thresh``, NMS at
    ``nms_thresh`` down to ``detections_per_im``, the drop of boxes whose
    rounded area is not positive, then the image's top
    ``detections_per_im`` -> (boxes (D, 4), labels (D,) 0-based,
    scores (D,))."""
    d = cfg["detections_per_im"]
    k = cfg["nms_topk_per_class"]
    cand_b, cand_s, cand_l = [], [], []
    for c in range(1, prob.shape[1]):
        ok = valid & (prob[:, c] > cfg["score_thresh"])
        if not bool(ok.any()):
            continue
        s, order = sort_desc(torch.where(ok, prob[:, c], -torch.inf))
        if k and k < len(s):
            s, order = s[:k], order[:k]
        b = box[order, c]
        kept = nms(b, torch.isfinite(s), cfg["nms_thresh"], d)
        cand_b.append(b[kept])
        cand_s.append(s[kept])
        cand_l.append(torch.full((len(kept),), c - 1, device=prob.device))
    if not cand_b:
        z = prob.new_zeros((0,))
        return prob.new_zeros((0, 4)), z.long(), z
    b, s, lab = torch.cat(cand_b), torch.cat(cand_s), torch.cat(cand_l)
    bi = torch.round(b)
    keep = (bi[:, 2] - bi[:, 0]) * (bi[:, 3] - bi[:, 1]) > 0
    b, s, lab = b[keep], s[keep], lab[keep]
    s, order = sort_desc(s)
    order = order[:d]
    return b[order], lab[order], s[:d]


# ---------------------------------------------------------------------------
# Preparation (cv2 INTER_LINEAR resize on the device, mean, bucket padding)


def _taps(in_size, out_size, inv_scale, device):
    d = torch.arange(out_size, dtype=torch.float64, device=device)
    src = ((d + 0.5) * inv_scale - 0.5).to(torch.float32)
    low = torch.floor(src)
    frac = src - low
    low = low.to(torch.int64)
    frac = torch.where(low < 0, 0.0, frac)
    low = torch.clamp(low, min=0)
    edge = low >= in_size - 1
    frac = torch.where(edge, 0.0, frac)
    low = torch.where(edge, in_size - 1, low)
    return low, torch.where(edge, low, low + 1), frac


def resize_bilinear(img, out_h, out_w, scale_y=None, scale_x=None):
    """(H, W, ...) -> (out_h, out_w, ...) float32, cv2 INTER_LINEAR
    (half-pixel centres, horizontal pass first)."""
    h, w = img.shape[:2]
    inv_y = 1.0 / scale_y if scale_y else h / out_h
    inv_x = 1.0 / scale_x if scale_x else w / out_w
    x = img.to(torch.float32)
    lo, hi, f = _taps(w, out_w, inv_x, img.device)
    f = f.reshape((1, -1) + (1,) * (x.dim() - 2))
    x = x[:, lo] * (1.0 - f) + x[:, hi] * f
    lo, hi, f = _taps(h, out_h, inv_y, img.device)
    f = f.reshape((-1,) + (1,) * (x.dim() - 1))
    return x[lo] * (1.0 - f) + x[hi] * f


def round_up(x, m):
    return (x + m - 1) // m * m


def resized_hw(cfg, h, w):
    """(scale, out_h, out_w): short side to ``min_size``, capped so the
    long side is at most ``max_size``."""
    scale = cfg["min_size"] / min(h, w)
    if scale * max(h, w) > cfg["max_size"]:
        scale = cfg["max_size"] / max(h, w)
    return scale, int(round(h * scale)), int(round(w * scale))


def bucket(cfg, h, w):
    short, long_ = round_up(cfg["min_size"], 64), round_up(cfg["max_size"], 64)
    if w >= h:
        return (short if h <= short else round_up(h, 64),
                long_ if w <= long_ else round_up(w, 64))
    return (long_ if h <= long_ else round_up(h, 64),
            short if w <= short else round_up(w, 64))


def batch_shape(cfg, sizes):
    """The padded (H, W) of a batch of original (h, w) sizes."""
    shapes = [bucket(cfg, *resized_hw(cfg, h, w)[1:]) for h, w in sizes]
    return max(s[0] for s in shapes), max(s[1] for s in shapes)


def prepare(cfg, img, padded_hw, device):
    """(3, H, W) 0-255 RGB -> ((1, 3, Hp, Wp) mean-subtracted, zero
    padded; the scale)."""
    _, h, w = img.shape
    scale, oh, ow = resized_hw(cfg, h, w)
    x = torch.as_tensor(np.asarray(img, np.float32), device=device)
    x = resize_bilinear(x.permute(1, 2, 0), oh, ow, scale, scale)
    x = x - torch.tensor(cfg["mean"], dtype=torch.float32, device=device)
    out = torch.zeros((1, 3) + tuple(padded_hw), device=device)
    out[0, :, :oh, :ow] = x.permute(2, 0, 1)
    return out, scale


# ---------------------------------------------------------------------------
# One image, end to end


def features(params, cfg, x, prec):
    f = backbone(params["extractor"], x, cfg["n_layers"], prec)
    locs, scores = rpn(params["rpn"], f, prec)
    anchor = anchors(cfg, f.shape[2], f.shape[3], f.device)
    return f, locs[0], scores[0], anchor


def detect(params, cfg, img, padded_hw, prec, device):
    """The reference's own detections of one (3, H, W) image padded to
    ``padded_hw``: dict of boxes, labels, scores, plus what later checks
    reuse (features, anchors' decoded rois, the scale)."""
    x, scale = prepare(cfg, img, padded_hw, device)
    f, locs, scores, anchor = features(params, cfg, x, prec)
    rois, valid = propose(cfg, locs, scores, anchor, padded_hw)
    out = head_chunked(params["head"], cfg, f, rois, prec)
    size = img.shape[1:]
    prob, box = class_boxes(cfg, rois, out["cls_loc"], out["score"], size,
                            scale)
    b, lab, s = select(cfg, prob, box, valid)
    all_rois = clip(loc2bbox(anchor, locs.float()), *padded_hw)
    return {"boxes": b, "labels": lab, "scores": s, "features": f,
            "anchor_rois": all_rois, "scale": scale}


def mask_probs(params, cfg, feat, boxes, labels, scale, prec):
    """Mask probabilities (R, 14, 14) of the class ``labels`` (0-based) at
    ``boxes`` (original-image coordinates)."""
    if len(boxes) == 0:
        return feat.new_zeros((0, cfg["mask_size"], cfg["mask_size"]))
    rois = boxes * torch.tensor(scale, dtype=torch.float32,
                                device=boxes.device)
    logits = head_chunked(params["head"], cfg, feat, rois, prec, bbox=False,
                          mask=True)["mask"]
    pick = logits[torch.arange(len(boxes)), labels.long()]
    return torch.sigmoid(pick)


# ---------------------------------------------------------------------------
# Detectron's paste: the 14x14 mask zero-padded to 16x16, the box expanded
# by 16/14, resized to the integer box, thresholded at 0.5, clipped


def paste(boxes, probs, im_h, im_w):
    """(R, 4) y1x1y2x2 and (R, M, M) numpy -> (R, im_h, im_w) bool."""
    r = len(boxes)
    out = np.zeros((r, im_h, im_w), dtype=bool)
    if r == 0:
        return out
    m = probs.shape[1]
    b = boxes[:, [1, 0, 3, 2]]
    s = (m + 2.0) / m
    w_half = (b[:, 2] - b[:, 0]) * 0.5 * s
    h_half = (b[:, 3] - b[:, 1]) * 0.5 * s
    x_c = (b[:, 2] + b[:, 0]) * 0.5
    y_c = (b[:, 3] + b[:, 1]) * 0.5
    ref = np.zeros(b.shape)
    ref[:, 0], ref[:, 2] = x_c - w_half, x_c + w_half
    ref[:, 1], ref[:, 3] = y_c - h_half, y_c + h_half
    ref = ref.astype(np.int32)
    padded = torch.zeros((m + 2, m + 2), dtype=torch.float32)
    for i in range(r):
        padded[1:-1, 1:-1] = torch.from_numpy(np.asarray(probs[i],
                                                         np.float32))
        x0r, y0r, x1r, y1r = ref[i]
        w = max(x1r - x0r + 1, 1)
        h = max(y1r - y0r + 1, 1)
        binar = (resize_bilinear(padded, int(h), int(w)) > 0.5).numpy()
        x0, x1 = max(x0r, 0), min(x1r + 1, im_w)
        y0, y1 = max(y0r, 0), min(y1r + 1, im_h)
        if x1 <= x0 or y1 <= y0:
            continue
        out[i, y0:y1, x0:x1] = binar[y0 - y0r:y1 - y0r, x0 - x0r:x1 - x0r]
    return out

