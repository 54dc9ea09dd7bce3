"""ctypes bindings for the native C++ evaluation code, the port of
``mask_rcnn_tpu/utils/native.py``.

Compiles ``mask_rcnn_tpu_torch/native/cocoeval.cpp`` (a copy of the JAX
package's) on first use with g++ -O3 -shared into the package's ``_build/``
directory (never next to the source) and exposes numpy-friendly wrappers.
This is host code, not a device kernel. Every entry point returns None when
the host has no g++, and its callers then take their numpy path, as the JAX
package's do. A g++ that fails to build the source raises, with its output:
a silent fallback would only make the evaluation much slower.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SRC = osp.join(_PKG, "native", "cocoeval.cpp")
_BUILD = osp.join(_PKG, "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_key() -> str:
    """Cache key distinguishing incompatible hosts: -march=native codegen
    from one CPU can SIGILL on another (a checkout shared across machines),
    so the .so name embeds the CPU's feature set."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    key = f"{platform.machine()}|{flags}"
    return hashlib.md5(key.encode()).hexdigest()[:10]


def _lib_path() -> str:
    return osp.join(_BUILD, f"cocoeval.{_host_key()}.so")


def _build() -> Optional[str]:
    lib_path = _lib_path()
    if osp.exists(lib_path) and (
        os.stat(lib_path).st_mtime >= os.stat(_SRC).st_mtime
    ):
        return lib_path
    if shutil.which("g++") is None:
        return None
    # Build to a per-process temp name, then atomically rename: concurrent
    # builders (parallel test workers, several processes of one run) must
    # never CDLL a half-written .so.
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    os.makedirs(_BUILD, exist_ok=True)
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"g++ failed to build {_SRC} (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            path = _build()  # a failed build raises, and the next call
            _tried = True    # tries again
            if path:
                lib = ctypes.CDLL(path)
                c_i64 = ctypes.c_int64
                lib.coco_match_image.argtypes = [
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_double),
                    c_i64, c_i64, c_i64,
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(ctypes.c_uint8),
                ]
                lib.mask_iou_packed.argtypes = [
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint8),
                    c_i64, c_i64, c_i64,
                    ctypes.POINTER(ctypes.c_double),
                ]
                lib.rle_encode.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), c_i64, c_i64,
                    ctypes.POINTER(ctypes.c_uint32),
                ]
                lib.rle_encode.restype = c_i64
                lib.boxlocal_inter.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(c_i64),
                    c_i64,
                    ctypes.POINTER(ctypes.c_uint8),
                    c_i64, c_i64, c_i64,
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(c_i64),
                    ctypes.POINTER(c_i64),
                ]
                _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def coco_match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                     gt_crowd: np.ndarray,
                     det_ignore: np.ndarray, thresholds: np.ndarray):
    """Native greedy matcher; returns (dtm (T, D) int64, dt_ig (T, D) bool).
    Returns None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    d, g = ious.shape
    t = len(thresholds)
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ig = np.ascontiguousarray(gt_ignore, np.uint8)
    gt_cr = np.ascontiguousarray(gt_crowd, np.uint8)
    det_ig = np.ascontiguousarray(det_ignore, np.uint8)
    thr = np.ascontiguousarray(thresholds, np.float64)
    dtm = np.empty((t, d), np.int64)
    dt_ig = np.zeros((t, d), np.uint8)
    lib.coco_match_image(
        _ptr(ious, ctypes.c_double), _ptr(gt_ig, ctypes.c_uint8),
        _ptr(gt_cr, ctypes.c_uint8),
        _ptr(det_ig, ctypes.c_uint8), _ptr(thr, ctypes.c_double),
        d, g, t, _ptr(dtm, ctypes.c_int64), _ptr(dt_ig, ctypes.c_uint8),
    )
    return dtm, dt_ig.astype(bool)


def mask_iou_packed(det_masks: np.ndarray, gt_masks: np.ndarray,
                    gt_crowd: np.ndarray):
    """Native pairwise mask IoU from (R, H, W) bool arrays, or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = det_masks.shape[0]
    g = gt_masks.shape[0]

    def pack64(m):
        flat = np.packbits(m.reshape(m.shape[0], -1), axis=1)
        pad = (-flat.shape[1]) % 8
        if pad:
            flat = np.pad(flat, ((0, 0), (0, pad)))
        return np.ascontiguousarray(flat).view(np.uint64)

    db = pack64(np.asarray(det_masks, bool))
    gb = pack64(np.asarray(gt_masks, bool))
    crowd = np.ascontiguousarray(gt_crowd, np.uint8)
    out = np.empty((d, g), np.float64)
    lib.mask_iou_packed(
        _ptr(db, ctypes.c_uint64), _ptr(gb, ctypes.c_uint64),
        _ptr(crowd, ctypes.c_uint8), d, g, db.shape[1],
        _ptr(out, ctypes.c_double),
    )
    return out


def rle_encode(mask: np.ndarray):
    """Native column-major RLE counts for a (H, W) binary mask, or None."""
    lib = get_lib()
    if lib is None or mask.size == 0:
        return None
    m = np.ascontiguousarray(mask, np.uint8)
    h, w = m.shape
    counts = np.empty(h * w + 1, np.uint32)
    n = lib.rle_encode(_ptr(m, ctypes.c_uint8), h, w,
                       _ptr(counts, ctypes.c_uint32))
    return counts[:n].astype(np.int64)


def boxlocal_inter(locals_, gt_masks: np.ndarray,
                   det_labels: np.ndarray, gt_labels: np.ndarray):
    """Native detection-vs-gt intersections + det areas from box-local masks.

    ``locals_``: list of ``(local (h, w) bool, y0, x0)`` from
    ``utils.masks.boxlocal_masks`` (already clipped to the image).
    Intersections are computed for label-equal pairs only (the evaluator
    never reads cross-class pairs; others are 0). Returns
    ``(inter (D, G) int64, det_area (D,) int64, gt_area (G,) int64)`` or
    None if the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    d = len(locals_)
    gt = np.asarray(gt_masks)
    if gt.dtype == bool:  # same memory layout: view, don't copy ~MBs
        gt = np.ascontiguousarray(gt).view(np.uint8)
    else:
        gt = np.ascontiguousarray(gt, np.uint8)
    g, im_h, im_w = gt.shape if gt.ndim == 3 else (0, 1, 1)
    meta = np.zeros((max(d, 1), 4), np.int64)
    offsets = np.zeros(d + 1, np.int64)
    for i, (local, y0, x0) in enumerate(locals_):
        h, w = local.shape
        if g and (y0 < 0 or x0 < 0 or y0 + h > im_h or x0 + w > im_w):
            # The C kernel indexes gt at gbase[(y0+y)*im_w + x0+x] with no
            # bounds checks; a caller whose im_size disagrees with the gt
            # mask resolution must fail loudly here (the numpy fallback
            # raises a broadcast error for the same inputs), not read out
            # of bounds.
            raise ValueError(
                f"box-local mask {i} at (y0={y0}, x0={x0}, h={h}, w={w}) "
                f"exceeds the gt mask extent ({im_h}, {im_w}) — im_size "
                "passed to add_boxlocal disagrees with gt_masks.shape?"
            )
        meta[i] = (y0, x0, h, w)
        offsets[i + 1] = offsets[i] + h * w
    buf = np.empty(max(int(offsets[-1]), 1), np.uint8)
    for i, (local, _, _) in enumerate(locals_):
        buf[offsets[i]:offsets[i + 1]] = local.reshape(-1)
    dl = np.ascontiguousarray(np.asarray(det_labels), np.int64)
    glb = np.ascontiguousarray(np.asarray(gt_labels), np.int64)
    inter = np.zeros((max(d, 1), max(g, 1)), np.int64)
    area = np.zeros(max(d, 1), np.int64)
    gt_area = np.zeros(max(g, 1), np.int64)
    if d and g:
        lib.boxlocal_inter(
            _ptr(buf, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(meta, ctypes.c_int64), d,
            _ptr(gt, ctypes.c_uint8), g, im_h, im_w,
            _ptr(dl, ctypes.c_int64), _ptr(glb, ctypes.c_int64),
            _ptr(inter, ctypes.c_int64), _ptr(area, ctypes.c_int64),
            _ptr(gt_area, ctypes.c_int64),
        )
    elif d:
        for i, (local, _, _) in enumerate(locals_):
            area[i] = int(local.sum())
    elif g:
        gt_area[:g] = gt.reshape(g, -1).sum(axis=1, dtype=np.int64)
    return inter[:d, :g], area[:d], gt_area[:g]
