"""Evaluation hook, the port of ``mask_rcnn_tpu/engine/evaluator.py``
(the reference's InstanceSegmentationCOCOEvaluator / VOCEvaluator).

In a process group (``parallel/mesh.py``) each rank scores a strided shard
of the dataset; the ranks exchange failure flags first, then either pool
their match records (``pool_detections``: the exact global metric) or
average their reports (the reference's chainermn evaluator), as the JAX
package does (its evaluator.py:245-399). ``VisReport`` draws ground truth
beside predictions with cv2 (``utils/visualizations.py``).
"""

from __future__ import annotations

import os
import os.path as osp
import queue as queue_mod
import threading
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from mask_rcnn_tpu_torch.data._image import write_jpeg
from mask_rcnn_tpu_torch.parallel.mesh import process_count, process_index
from mask_rcnn_tpu_torch.utils.cocoeval import COCOEvaluation
from mask_rcnn_tpu_torch.utils.visualizations import (
    get_tile_image,
    require_cv2,
    visualize_instance_segmentation,
)
from mask_rcnn_tpu_torch.utils.voc_eval import VOCEvaluation


def _all_gather(obj) -> list:
    """Every rank's ``obj`` in rank order (CPU objects: gloo has no CUDA
    all_gather; under NCCL the rank's device is set by
    ``init_distributed``)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class InstanceSegmentationEvaluator:
    """Runs the model's predict over a dataset and computes COCO or VOC
    metrics.

    Report keys are the reference extensions' (JAX evaluator.py:280-305):
    'validation/main/map', 'validation/main/map@0.5',
    'validation/main/map@0.75' (COCO), per-class
    'validation/main/ap/<class>'.
    """

    def __init__(
        self,
        dataset,
        class_names: Sequence[str],
        kind: str = "coco",
        batch_size: int = 2,
        use_07_metric: bool = False,
        max_examples: Optional[int] = None,
        pool_detections: bool = False,
    ):
        """``pool_detections``: with several processes, gather every
        rank's compact match records and score them together (the exact
        global metric, identical on every rank); off, the ranks' reports
        are averaged (the reference's chainermn evaluator). One process:
        no effect."""
        if kind not in ("coco", "voc"):
            raise ValueError(f"kind must be 'coco' or 'voc', got {kind!r}")
        self.dataset = dataset
        self.class_names = list(class_names)
        self.kind = kind
        self.batch_size = batch_size
        self.use_07_metric = use_07_metric
        self.max_examples = max_examples
        self.pool_detections = pool_detections

    def __call__(self, model) -> Dict[str, float]:
        n = len(self.dataset)
        if self.max_examples:
            n = min(n, self.max_examples)
        # Each rank scores a strided shard (JAX evaluator.py:61-67).
        pi, pc = process_index(), process_count()
        indices = list(range(n))[pi::pc]
        # Sharded predict pads its batch to the device count anyway.
        batch_size = max(self.batch_size,
                         len(getattr(model, "devices", None) or ()))

        # Streaming accumulation: each batch's full-resolution masks are
        # matched into compact per-(image, class) IoU/score records right
        # after predict and then freed — a COCO-minival-scale sweep (5k
        # images x 100 dets x ~1 MP bool masks would be ~100+ GB as lists)
        # stays at a bounded RSS. Reference analog: streaming
        # apply_to_iterator -> eval_instseg_coco
        # (extensions/instance_segmentation_coco_evaluator.py:36-52).
        # Scoring runs on a worker thread (bounded queue) so the IoU
        # matching of batch i overlaps the device predict of batch i+1
        # (numpy and the native matcher release the GIL).
        ev = (
            COCOEvaluation("segm")
            if self.kind == "coco"
            else VOCEvaluation(use_07_metric=self.use_07_metric)
        )
        n_added = 0
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        failure = []

        def scorer():
            failed = False
            while True:
                item = q.get()
                if item is None:
                    return
                if failed:
                    continue  # keep draining so the producer never blocks
                try:
                    for fn, args in item:
                        getattr(ev, fn)(*args)
                except BaseException as e:  # surfaced after join
                    failure.append(e)
                    failed = True

        t = threading.Thread(target=scorer, daemon=True)
        t.start()

        def gt_extras(e):
            """(crowds, areas) of an example tuple. The dataset's
            return_crowd/return_area flags say which optional fields are
            present — guessing positionally would read a crowd-less
            areas-only 5-tuple's areas as crowd flags (every gt becomes an
            ignored crowd and the mAP is silently garbage)."""
            rc = getattr(self.dataset, "return_crowd", None)
            ra = getattr(self.dataset, "return_area", None)
            if rc is None and ra is None:
                if len(e) > 5:
                    return e[4], e[5]
                if len(e) > 4:
                    raise ValueError(
                        "dataset yields a 5-tuple but exposes no "
                        "return_crowd/return_area attributes — cannot tell "
                        "whether element 4 is crowd flags or areas"
                    )
                return None, None
            j = 4
            crowds = areas = None
            if rc:
                crowds = e[j]
                j += 1
            if ra:
                areas = e[j]
            return crowds, areas

        def enqueue(examples, results):
            nonlocal n_added
            bboxes, masks, labels, scores = results
            work = []
            for e, mk, lb, sc in zip(examples, masks, labels, scores):
                gt_mask = np.asarray(e[3], bool)
                if self.kind == "coco":
                    crowds, areas = gt_extras(e)
                    work.append(("add", (
                        mk, lb, sc, gt_mask, e[2], crowds, areas,
                    )))
                else:
                    work.append(("add", (mk, lb, sc, gt_mask, e[2])))
                n_added += 1
            q.put(work)

        def enqueue_raw(examples, results):
            """Box-local scoring: masks never pasted to full resolution
            (``add_boxlocal`` computes the identical integer-count IoUs
            from each detection's box crop)."""
            nonlocal n_added
            bboxes, probs, labels, scores, sizes = results
            work = []
            for e, bb, pr, lb, sc, size in zip(
                examples, bboxes, probs, labels, scores, sizes
            ):
                gt_mask = np.asarray(e[3], bool)
                if self.kind == "coco":
                    crowds, areas = gt_extras(e)
                    work.append(("add_boxlocal", (
                        bb, pr, lb, sc, size, gt_mask, e[2], crowds, areas,
                    )))
                else:
                    work.append(("add_boxlocal",
                                 (bb, pr, lb, sc, size, gt_mask, e[2])))
                n_added += 1
            q.put(work)

        # Double-buffered sweep: batch i+1 is decoded and dispatched to the
        # device before batch i's detections are fetched and pasted, so host
        # decode + paste + transfers overlap device compute (the api layer's
        # predict_submit/predict_collect split; results are bitwise identical
        # to sequential predict — tests/test_torch_collect.py). Models without
        # the split (bare test stubs) fall back to blocking predict.
        submit = getattr(model, "predict_submit", None)
        collect_raw = getattr(model, "predict_collect_raw", None)

        def _definer(name):
            for k in type(model).__mro__:
                if name in vars(k):
                    return k
            return None

        # Prefer raw (paste-free) collection, but never shadow a subclass
        # that overrides predict_collect below where predict_collect_raw is
        # defined — such an override post-processes detections and must
        # stay authoritative for evaluation.
        raw_cls, collect_cls = _definer("predict_collect_raw"), _definer(
            "predict_collect"
        )
        use_raw = collect_raw is not None and (
            collect_cls is None or (
                raw_cls is not None and issubclass(raw_cls, collect_cls)
            )
        )
        inst = getattr(model, "__dict__", {})
        if "predict_collect" in inst and "predict_collect_raw" not in inst:
            use_raw = False  # instance-level override wins likewise
        if use_raw:
            collect, ingest = collect_raw, enqueue_raw
        else:
            collect, ingest = getattr(model, "predict_collect", None), enqueue
        pipelined = submit is not None and collect is not None
        sweep_error = None
        try:
            pending = None  # (handle, examples): one device batch in flight
            try:
                for start in range(0, len(indices), batch_size):
                    examples = [
                        self.dataset[i]
                        for i in indices[start:start + batch_size]
                    ]
                    imgs = [e[0].transpose(2, 0, 1).astype(np.float32)
                            for e in examples]
                    if pipelined:
                        handle = submit(imgs)
                        if pending is not None:
                            ingest(pending[1], collect(pending[0]))
                        pending = (handle, examples)
                    else:
                        enqueue(examples, model.predict(imgs))
                    if failure:
                        pending = None
                        break
                if pending is not None:
                    ingest(pending[1], collect(pending[0]))
            finally:
                q.put(None)
                t.join()
            if failure:
                raise RuntimeError(
                    "evaluation scoring failed") from failure[0]
        except BaseException as e:
            # Several processes: raising here would leave the other ranks
            # blocked in the collectives below. Exchange failure flags
            # first (every rank reaches it), then raise everywhere.
            if pc == 1:
                raise
            sweep_error = e
        if pc > 1:
            flags = _all_gather(sweep_error is not None)
            bad = [r for r, f in enumerate(flags) if f]
            if bad:
                raise RuntimeError(
                    f"evaluation failed on process(es) {bad}"
                ) from sweep_error
        if pc > 1 and self.pool_detections:
            # The exact global metric: every rank rebuilds the union of the
            # shards' records in rank order and scores it.
            n_added = self._pool_states(ev, n_added)

        # An empty shard (or dataset) reports no keys; with several
        # processes it still joins the averaging below, where its all-NaN
        # vector is ignored.
        report = {}
        if n_added and self.kind == "coco":
            res = ev.results()
            report["validation/main/map"] = res[
                "map/iou=0.50:0.95/area=all/maxDets=100"
            ]
            report["validation/main/map@0.5"] = res[
                "map/iou=0.50/area=all/maxDets=100"
            ]
            report["validation/main/map@0.75"] = res[
                "map/iou=0.75/area=all/maxDets=100"
            ]
            class_ap = res["ap/iou=0.50:0.95/area=all/maxDets=100"]
            for cid, ap in zip(res["class_ids"], class_ap):
                if 0 <= cid < len(self.class_names):
                    report[
                        f"validation/main/ap/{self.class_names[cid]}"
                    ] = float(ap)
        elif n_added:
            res = ev.results()
            report["validation/main/map"] = res["map"]
            for cid, ap in enumerate(res["ap"]):
                if not np.isnan(ap) and cid < len(self.class_names):
                    report[
                        f"validation/main/ap/{self.class_names[cid]}"
                    ] = float(ap)
        if pc > 1 and not self.pool_detections:
            report = self._aggregate_reports(report)
        return report

    @staticmethod
    def _pool_states(ev, n_added: int) -> int:
        """Gather every rank's ``(n_added, ev.get_state())`` in rank order
        and rebuild ``ev`` from them: every rank holds the same records in
        the same order, so tied scores break alike and the pooled metric
        is identical on every rank. Returns the global example count."""
        total = 0
        for rank, (count, state) in enumerate(
                _all_gather((n_added, ev.get_state()))):
            total += count
            if rank == 0:
                ev.set_state(state)
            else:
                ev.merge_state(state)
        return total

    # -- report averaging across processes --------------------------------
    _SCALAR_KEYS = (
        "validation/main/map",
        "validation/main/map@0.5",
        "validation/main/map@0.75",
    )

    def _report_to_vector(self, report: Dict[str, float]) -> np.ndarray:
        vec = np.full(len(self._SCALAR_KEYS) + len(self.class_names),
                      np.nan, np.float32)
        for i, k in enumerate(self._SCALAR_KEYS):
            if k in report:
                vec[i] = report[k]
        for cid, name in enumerate(self.class_names):
            k = f"validation/main/ap/{name}"
            if k in report:
                vec[len(self._SCALAR_KEYS) + cid] = report[k]
        return vec

    def _vector_to_report(self, vec: np.ndarray) -> Dict[str, float]:
        report = {}
        for i, k in enumerate(self._SCALAR_KEYS):
            if np.isfinite(vec[i]):
                report[k] = float(vec[i])
        for cid, name in enumerate(self.class_names):
            v = vec[len(self._SCALAR_KEYS) + cid]
            if np.isfinite(v):
                report[f"validation/main/ap/{name}"] = float(v)
        return report

    def _aggregate_reports(self, report: Dict[str, float]):
        """The mean of the ranks' reports (float32, NaN = the key is absent
        on that rank). Every rank must call it."""
        gathered = np.stack(_all_gather(self._report_to_vector(report)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cols
            mean = np.nanmean(gathered, axis=0)
        return self._vector_to_report(mean)


class VisReport:
    """GT-vs-prediction tile renderer (reference
    extensions/instance_segmentation_vis_report.py:16-98), the port of the
    JAX package's ``VisReport``: one (GT | prediction) panel for each of
    ``indices``, tiled, written to ``<out_dir>/visualizations/`` as
    ``iteration=%08d.jpg`` and ``latest.jpg``.

    The drawing needs cv2 (which also writes the JPEG): the constructor
    imports it, so a training run without it fails before its first step
    and not at its first evaluation. No collective runs inside: in a
    process group only rank 0 calls it (``engine/loop.py``)."""

    def __init__(self, dataset, class_names, out_dir,
                 indices: Sequence[int] = (0, 1, 2, 3, 4, 5, 6, 7, 8),
                 score_thresh: float = 0.7):
        require_cv2()
        self.dataset = dataset
        self.class_names = list(class_names)
        self.out_dir = out_dir
        self.indices = [i for i in indices if i < len(dataset)]
        self.score_thresh = score_thresh

    def __call__(self, model, iteration: int = 0):
        panels = []
        for i in self.indices:
            e = self.dataset[i]
            img = e[0]
            chw = img.transpose(2, 0, 1).astype(np.float32)
            bboxes, masks, labels, scores = model.predict([chw])
            keep = scores[0] >= self.score_thresh
            panel = visualize_instance_segmentation(
                img, e[1], e[2], np.asarray(e[3], bool),
                bboxes[0][keep], labels[0][keep], masks[0][keep],
                scores[0][keep], n_class=len(self.class_names),
            )
            panels.append(panel)
        if not panels:
            return None
        tile = get_tile_image(panels)
        vis_dir = osp.join(self.out_dir, "visualizations")
        os.makedirs(vis_dir, exist_ok=True)
        write_jpeg(osp.join(vis_dir, "iteration=%08d.jpg" % iteration), tile)
        write_jpeg(osp.join(vis_dir, "latest.jpg"), tile)
        return tile
