"""Small iteration helpers (reference utils/_itertools.py parity), a copy
of ``mask_rcnn_tpu/utils/_itertools.py``."""


def batch(iterable, n=1):
    """Yield fixed-size chunks (last chunk may be shorter)."""
    items = list(iterable)
    for i in range(0, len(items), n):
        yield items[i:i + n]
