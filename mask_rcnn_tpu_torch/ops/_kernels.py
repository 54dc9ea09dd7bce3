"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object file,
all of them at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
the first call of :func:`lib` (never at import, so the package imports on a
machine without ``nvcc``), into ``mask_rcnn_tpu_torch/_build/`` keyed by a
hash of the sources and flags, and is reused while they are unchanged.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("roi_align.cu", "nms.cu", "targets.cu", "roi_pool.cu", "stem.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mrcnn_roi_align_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                            _I, _P),
    "mrcnn_roi_align_bwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                            _I, _P),
    # (feats/grad, rois, roi_idx, out/grad_feats, dtype, N, R, H, W, C, P,
    #  spatial_scale, sampling_ratio, bin_stride, stream)
    "mrcnn_roi_align_flat_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _F, _I, _I, _P),
    "mrcnn_roi_align_flat_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _F, _I, _I, _P),
    # (x, w, scale, bias, out, dtype, N, H, W, stream)
    "mrcnn_stem_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (anchors, gt, gt_valid, pri_pos, pri_neg, N, S, G, h, w, pos_thresh,
    #  neg_thresh, pos_quota, n_sample, loc, label, stream)
    "mrcnn_anchor_targets": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                             _I, _I, _P, _P, _P),
    # (roi, roi_valid, gt, gt_valid, gt_class, masks, pri_pos, pri_neg,
    #  norm, N, P0, G, H, Wm, packed, pos_thresh, neg_hi, neg_lo, n_sample,
    #  pos_quota, M, sample_roi, gt_loc, gt_label, gt_mask, stream)
    "mrcnn_proposal_targets": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, _F, _F, _I, _I, _I, _P, _P,
                               _P, _P, _P),
    "mrcnn_targets_limits": (_P,),  # int[3]
    # (pointers..., dtype, N, R, H, W, C, P, spatial_scale, stream)
    "mrcnn_crop_resize_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                              _P),
    "mrcnn_crop_resize_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                              _P),
    "mrcnn_roi_pool_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "mrcnn_roi_pool_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                           _P),
    "mrcnn_nms_blocked": (_P, _P, _P, _I, _I, _F, _I, _P, _P, _P),
    "mrcnn_nms_small": (_P, _P, _I, _I, _F, _I, _P, _P, _P),
    "mrcnn_nms_kept_cap": (),
    # (prob, boxes, roi_valid, N, Rp, C, score_thresh, k, nms_thresh, D,
    #  s_boxes, s_scores, s_counts, tickets, out_boxes, out_labels,
    #  out_scores, out_valid, stream)
    "mrcnn_decode_select": (_P, _P, _P, _I, _I, _I, _F, _I, _F, _I, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P),
    "mrcnn_decode_limits": (_P,),  # int[4]
}

_lock = threading.Lock()
_lib = None
# What nvcc printed for the build of this process (ptxas registers and
# spills per kernel); empty when the library came from an earlier build.
build_info = {"log": ""}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    return res.stdout + res.stderr


def library() -> Path:
    """The library's path, keyed by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmrcnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(n).stem}.{tag}.o" for n in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = list(pool.map(
            lambda src_obj: _run([nvcc, *NVCC_FLAGS, "-c", "-o",
                                  str(src_obj[1]), str(CSRC / src_obj[0])]),
            zip(SOURCES, objs),
        ))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    logs.append(_run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    build_info["log"] = "".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, in the set-up span
    ``mrcnn.kernels_build`` (nvcc ran) or ``mrcnn.kernels_load``."""
    global _lib
    with _lock:
        if _lib is None:
            from mask_rcnn_tpu_torch.utils import profiling

            what = "load" if library().exists() else "build"
            with profiling.setup_span(f"mrcnn.kernels_{what}"):
                so = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
            _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
