"""Dataset concatenation (reference: ``chainer.datasets.ConcatenatedDataset``
used by examples/coco/train.py:16-31 to join train2014 + valminusminival),
a copy of ``mask_rcnn_tpu/data/concat.py``.

Unlike a bare example-local concat, this forwards the ``image_sizes``
metadata protocol so the TrainLoader keeps aspect-ratio grouping across the
joined datasets — without it the flagship COCO config would batch portrait
with landscape and pad every batch to the square worst case.
"""

from __future__ import annotations


class ConcatDataset:
    """Concatenation of datasets sharing one example schema.

    Exposes ``image_sizes()`` iff every child does, concatenated in child
    order to match ``__getitem__`` indexing.
    """

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = datasets
        self._lengths = [len(d) for d in datasets]

    def __len__(self):
        return sum(self._lengths)

    def __getitem__(self, i):
        if i < 0:
            i += len(self)
        for d, n in zip(self.datasets, self._lengths):
            if i < n:
                return d[i]
            i -= n
        raise IndexError("ConcatDataset index out of range")

    def __getattr__(self, name):
        # Forward schema metadata (class_names etc.) from the first child;
        # __getattr__ only fires for attributes not set on the instance.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.datasets[0], name)

    def image_sizes(self):
        """Concatenated (H, W) list when every child provides one; raises
        AttributeError otherwise so the TrainLoader's ``getattr`` probe
        falls back to no-grouping (with its warning)."""
        sizes = []
        for d in self.datasets:
            fn = getattr(d, "image_sizes", None)
            if fn is None:
                raise AttributeError(
                    f"{type(d).__name__} does not expose image_sizes"
                )
            sizes.extend(fn() if callable(fn) else fn)
        return sizes
