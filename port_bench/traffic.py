"""The one traffic generator: it reads a traffic file's parameters
(``port_bench/traffic/<name>.json``) and makes the images, the arrivals and
the train batches of a run from ``--seed``.

Every seed gets the same multiset of sizes, batch compositions, instance
counts and arrival gaps, in another order, with other pixels and boxes:
so the work of a run does not move with the seed, and two seeds differ as
two runs of one seed do.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from port_bench.weights import generator


def rng(seed, stream):
    return np.random.default_rng([int(seed) % 2 ** 128, stream])


def spread(lo, hi, n):
    """n values evenly spread over [lo, hi] (the quantiles' midpoints)."""
    return [lo + (i + 0.5) / n * (hi - lo) for i in range(n)]


def apportion(shares, n):
    """Whole counts summing to n in proportion to ``shares`` (largest
    remainder)."""
    raw = [s * n / sum(shares) for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[
            :n - sum(counts)]:
        counts[i] += 1
    return counts


def batch_orientations(t, n_batches, batch):
    """Portrait flags of each batch: the numbers of portrait images a batch
    holds, in binomial proportion to ``portrait_share``, or whole batches
    of one orientation (``same_orientation``), as the train loader groups
    them."""
    p = t["images"]["portrait_share"]
    if t.get("same_orientation"):
        k = apportion([1 - p, p], n_batches)
        return [[False] * batch] * k[0] + [[True] * batch] * k[1]
    shares = [math.comb(batch, k) * p ** k * (1 - p) ** (batch - k)
              for k in range(batch + 1)]
    out = []
    for k, count in enumerate(apportion(shares, n_batches)):
        out += [[True] * k + [False] * (batch - k)] * count
    return out


def image_sizes(t, seed, n_batches, batch):
    """[(h, w)] a batch, ``n_batches`` batches: long side fixed, short sides
    evenly spread over their range, orientations as
    :func:`batch_orientations`, all in the seed's order."""
    im = t["images"]
    r = rng(seed, 1)
    flags = batch_orientations(t, n_batches, batch)
    flags = [flags[i] for i in r.permutation(len(flags))]
    flags = [[fl[i] for i in r.permutation(batch)] for fl in flags]
    n = n_batches * batch
    n_port = sum(map(sum, flags))
    shorts = [int(round(s)) for s in spread(im["short_min"], im["short_max"],
                                            n)]
    # the portrait images' short sides: evenly spread over the range too
    port = {int((i + 0.5) * n / n_port) for i in range(n_port)}
    sides = {True: [s for i, s in enumerate(shorts) if i in port],
             False: [s for i, s in enumerate(shorts) if i not in port]}
    for k in sides:
        sides[k] = [sides[k][i] for i in r.permutation(len(sides[k]))]
    out = []
    for fl in flags:
        sizes = []
        for portrait in fl:
            s = sides[portrait].pop()
            sizes.append((im["long"], s) if portrait else (s, im["long"]))
        out.append(sizes)
    return out


def pixels(seed, sizes, device):
    """Host (3, h, w) float32 images of whole values 0-255, drawn on the
    device and copied once."""
    g = generator(seed, device, 2)
    flat = torch.randint(0, 256, (sum(3 * h * w for h, w in sizes),),
                         generator=g, device=device, dtype=torch.uint8)
    host = flat.cpu().numpy().astype(np.float32)
    out, off = [], 0
    for h, w in sizes:
        out.append(host[off:off + 3 * h * w].reshape(3, h, w))
        off += 3 * h * w
    return out


def serve_batches(t, seed, device):
    """The pool of serving batches: [[(3, h, w) image, ...], ...]."""
    sizes = image_sizes(t, seed, t["pool_batches"], t["batch"])
    imgs = pixels(seed, [s for b in sizes for s in b], device)
    it = iter(imgs)
    return [[next(it) for _ in b] for b in sizes]


def arrivals(t, seconds):
    """Poisson arrivals at ``rate`` a second: the exponential's quantiles
    at their midpoints for the requests a window of ``seconds`` needs, in
    the order of the traffic's own ``arrival_seed``, the same in every run
    (with a queue at four fifths of its capacity, the order of the gaps
    moves the 95th percentile more than anything the program does) ->
    offsets (s) from the window's start."""
    n = int(math.ceil(t["rate"] * seconds)) + 1
    gaps = [-math.log(1 - (i + 0.5) / n) / t["rate"] for i in range(n)]
    gaps = [gaps[i] for i in rng(t["arrival_seed"], 3).permutation(n)]
    return list(np.cumsum(gaps) - gaps[0])


# ---------------------------------------------------------------------------
# Train batches


def instance_counts(tr, n):
    """n instance counts with COCO's heavy tail: a discretised lognormal at
    its quantiles, clipped to [1, max_boxes]."""
    sigma = tr["instances_sigma"]
    mu = math.log(tr["instances_mean"]) - sigma * sigma / 2
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [int(min(max(round(math.exp(mu + sigma * v)), 1),
                    tr["max_boxes"])) for v in z]


def resized(model, h, w):
    scale = model["min_size"] / min(h, w)
    if scale * max(h, w) > model["max_size"]:
        scale = model["max_size"] / max(h, w)
    return scale, int(round(h * scale)), int(round(w * scale))


def bucket(model, portrait):
    short = -(-model["min_size"] // 64) * 64
    long_ = -(-model["max_size"] // 64) * 64
    return (long_, short) if portrait else (short, long_)


def train_batches(t, model, seed, device):
    """The pool of train batches on the device: dicts of image (N, H, W, 3)
    float32 mean-subtracted and zero-padded, bbox (N, G, 4), label (N, G),
    bbox_valid (N, G), mask (N, G, H, W/8) bit-packed ellipses inside the
    boxes, scale (N,). Every batch is of one orientation."""
    tr = t["instances"]
    nb, b, g = t["pool_batches"], t["batch"], tr["max_boxes"]
    sizes = image_sizes(t, seed, nb, b)
    r = rng(seed, 4)
    counts = instance_counts(tr, nb * b)
    counts = [counts[i] for i in r.permutation(len(counts))]
    total = sum(counts)
    cats = []
    for cat, k in zip(("small", "medium", "large"),
                      apportion([tr["area_shares"][c] for c in
                                 ("small", "medium", "large")], total)):
        cats += [cat] * k
    cats = [cats[i] for i in r.permutation(total)]
    gen = generator(seed, device, 5)
    mean = torch.tensor(model["mean"], device=device)
    batches, inst = [], 0
    for bi, bsizes in enumerate(sizes):
        portrait = bsizes[0][0] > bsizes[0][1]
        hp, wp = bucket(model, portrait)
        image = torch.zeros((b, hp, wp, 3), device=device)
        bbox = torch.zeros((b, g, 4), device=device)
        label = torch.zeros((b, g), dtype=torch.int32, device=device)
        valid = torch.zeros((b, g), dtype=torch.bool, device=device)
        mask = torch.zeros((b, g, hp, wp), dtype=torch.bool, device=device)
        scales = torch.zeros((b,), device=device)
        for j, (h, w) in enumerate(bsizes):
            scale, rh, rw = resized(model, h, w)
            scales[j] = scale
            pix = torch.randint(0, 256, (rh, rw, 3), generator=gen,
                                device=device)
            image[j, :rh, :rw] = pix.float() - mean
            n = counts[bi * b + j]
            u = torch.rand((n, 4), generator=gen, device=device).cpu().numpy()
            lab = torch.randint(0, model["n_fg_class"], (n,), generator=gen,
                                device=device)
            for k in range(n):
                lo, hi = tr["side_px"][cats[inst + k]]
                side = lo + u[k, 0] * (hi - lo)
                aspect = math.exp((u[k, 1] - 0.5) * 2 * math.log(2.0))
                bh = min(side * math.sqrt(aspect), h - 2)
                bw = min(side / math.sqrt(aspect), w - 2)
                y1 = u[k, 2] * (h - bh)
                x1 = u[k, 3] * (w - bw)
                box = [y1 * scale, x1 * scale, (y1 + bh) * scale,
                       (x1 + bw) * scale]
                bbox[j, k] = torch.tensor(box, device=device)
                yy = torch.arange(hp, device=device)[:, None] + 0.5
                xx = torch.arange(wp, device=device)[None, :] + 0.5
                cy, cx = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
                ry = max((box[2] - box[0]) / 2, 0.5)
                rx = max((box[3] - box[1]) / 2, 0.5)
                mask[j, k] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            label[j, :n] = lab.int()
            valid[j, :n] = True
            inst += n
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=device,
                               dtype=torch.uint8)
        packed = (mask.reshape(b, g, hp, wp // 8, 8).to(torch.uint8)
                  * weights).sum(-1, dtype=torch.uint8)
        batches.append({"image": image, "bbox": bbox, "label": label,
                        "bbox_valid": valid, "mask": packed, "scale": scales})
    return batches


def priorities(t, seed, step, n, n_anchor, n_cand, device):
    """The sampling priorities of a train step: uniform draws for the
    anchors, and for the proposals the candidates' own order (the first
    candidate first), which the RPN's rounding can only reshuffle among
    near-equal proposals."""
    g = generator(seed, device, 1000 + step)
    anchor = tuple(torch.rand((n, n_anchor), generator=g, device=device)
                   for _ in range(2))
    order = torch.linspace(1.0, 0.0, n_cand, device=device)
    prop = tuple(order.expand(n, n_cand).contiguous() for _ in range(2))
    return {"anchor": anchor, "proposal": prop}
