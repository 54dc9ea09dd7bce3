"""Data helpers: static bucket shapes, mask bit-packing, padded batches, the
prefetching train loader, the train/eval transform, synthetic train
batches."""

from mask_rcnn_tpu_torch.data.loader import TrainLoader, pad_batch  # noqa
from mask_rcnn_tpu_torch.data.transforms import MaskRCNNTransform  # noqa
