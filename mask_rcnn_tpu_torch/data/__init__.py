"""Data: static bucket shapes, mask bit-packing, padded batches, the
prefetching train loader, the train/eval transform, the COCO, VOC2012, SBD
and VOC-like datasets (read without cv2 or PIL where the format allows),
and synthetic batches and dataset roots."""

from mask_rcnn_tpu_torch.data.coco import (  # noqa: F401
    COCOInstanceSegmentationDataset,
)
from mask_rcnn_tpu_torch.data.concat import ConcatDataset  # noqa: F401
from mask_rcnn_tpu_torch.data.legacy import MaskRcnnDataset  # noqa: F401
from mask_rcnn_tpu_torch.data.loader import TrainLoader, pad_batch  # noqa
from mask_rcnn_tpu_torch.data.transforms import MaskRCNNTransform  # noqa
from mask_rcnn_tpu_torch.data.voc import (  # noqa: F401
    IndexingDataset,
    SBDInstanceSegmentationDataset,
    VOC2012InstanceSegmentationDataset,
    VOCLikeDataset,
)
