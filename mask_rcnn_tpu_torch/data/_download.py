"""The datasets' ``download()``, the port of
``mask_rcnn_tpu/data/_download.py``: nothing is fetched. The reference
delegates to fcn's ``cached_download`` (an md5-verified cache,
datasets/coco.py:24-50, datasets/voc/voc.py:46-47); here every dataset's
``download()`` prints the sources and md5-checks the archives already on
disk, one loop for COCO, VOC and SBD.
"""

from __future__ import annotations

import hashlib
import os.path as osp
from typing import Iterable, Optional, Tuple


def _file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def print_sources_and_verify(
    root: str, archives: Iterable[Tuple[str, str, Optional[str]]]
) -> None:
    """Print fetch instructions; md5-check archives already present.

    ``archives``: (name, url, md5) triples. ``name`` may carry a
    subdirectory (e.g. COCO's 'annotations/...zip'): the documented
    location is checked first, then a flat root-level fallback.
    """
    root = osp.expanduser(root)
    print("No network egress in this environment. Fetch manually:")
    for name, url, md5 in archives:
        candidates = [osp.join(root, name)]
        flat = osp.join(root, osp.basename(name))
        if flat not in candidates:
            candidates.append(flat)
        path = next((p for p in candidates if osp.exists(p)), None)
        status = ""
        if path is not None and md5:
            digest = _file_md5(path)
            status = "  [md5 OK]" if digest == md5 else (
                f"  [md5 MISMATCH: {digest} != {md5}]"
            )
        print(f"  {name}: {url}{status}")
