"""Inference demo, the port of ``examples/demo.py`` (the reference's
examples/demo.py): rebuild a model from a log dir's ``params.yaml`` and
``snapshot_model.npz`` (``log_dir.py``), predict on images, draw the
detections above ``--score-thresh`` and write one numbered picture an
input (``000_<name>``, ``001_<name>``, ...), so inputs that share a name
keep their own output. The model predicts at ``--score-thresh`` itself, so
a threshold below the evaluation's 0.05 shows more (the JAX demo keeps
the model at 0.05 and filters after).

    python -m mask_rcnn_tpu_torch.examples.demo LOG_DIR --images A.jpg B.png \\
        [--score-thresh 0.7] [--out DIR] [--device cuda]

Images are read before the model is built, so a bad path fails at once.
Paths go through ``data/_image.py::read_rgb`` (PNG in numpy, JPEG through
cv2 or PIL); an ``http(s)://`` URL is fetched with urllib, as the
reference's imread allows. Drawing and writing need cv2.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import tempfile

import numpy as np


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a file path or an http(s) URL."""
    from mask_rcnn_tpu_torch.data._image import read_rgb

    if not path.startswith(("http://", "https://")):
        return read_rgb(path)
    import urllib.request

    data = urllib.request.urlopen(path).read()
    suffix = osp.splitext(path.split("?")[0])[1]
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(data)
        f.flush()
        return read_rgb(f.name)


def main(argv=None):
    """Returns the paths written, in input order."""
    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", help="logs/<timestamp> directory")
    parser.add_argument("--images", nargs="+", required=True)
    parser.add_argument("--score-thresh", type=float, default=0.7)
    parser.add_argument("--out", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to predict on ('cpu' runs every kernel's plain "
        "version)",
    )
    args = parser.parse_args(argv)

    from mask_rcnn_tpu_torch.examples.log_dir import build_model_from_log_dir
    from mask_rcnn_tpu_torch.utils import _itertools
    from mask_rcnn_tpu_torch.utils.visualizations import (
        draw_instance_bboxes,
        require_cv2,
    )

    cv2 = require_cv2()
    # load (and fail on bad paths) before the expensive model build
    imgs = [(path, load_image(path)) for path in args.images]

    model, _ = build_model_from_log_dir(args.log_dir, device=args.device)
    # The model's own threshold (0.05 after the build) would drop what a
    # lower --score-thresh asks to see.
    model.score_thresh = args.score_thresh
    out_dir = args.out or tempfile.mkdtemp(prefix="mask_rcnn_torch_demo_")
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for chunk in _itertools.batch(imgs, n=2):
        chw = [im.transpose(2, 0, 1).astype(np.float32) for _, im in chunk]
        bboxes, masks, labels, scores = model.predict(chw)
        for (path, img), bb, mk, lb, sc in zip(
            chunk, bboxes, masks, labels, scores
        ):
            keep = sc >= args.score_thresh
            order = np.argsort(-sc[keep])
            viz = draw_instance_bboxes(
                img, bb[keep][order], lb[keep][order],
                n_class=model.n_class, masks=mk[keep][order],
                scores=sc[keep][order],
            )
            # numbered prefix: inputs sharing a basename (or URLs with
            # query strings) must not overwrite each other's output
            base = osp.basename(path).split("?")[0] or "image.jpg"
            out_path = osp.join(out_dir, f"{len(written):03d}_{base}")
            if not cv2.imwrite(out_path, viz[:, :, ::-1]):
                raise IOError(f"failed to write {out_path}")
            written.append(out_path)
            print(f"{path}: {int(keep.sum())} detections -> {out_path}")
    return written


if __name__ == "__main__":
    main()
