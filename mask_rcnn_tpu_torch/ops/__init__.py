"""Ops: boxes, anchors, losses, NMS (kernels K2, K3), the RoI poolers
(RoIAlign K1/K7, crop-and-resize K5/K11, max RoI pooling K6/K12) and the
target creators' matching and mask crop-resize (K9, K8)."""

from mask_rcnn_tpu_torch.ops.roi_align import crop_and_resize  # noqa: F401
from mask_rcnn_tpu_torch.ops.roi_align import roi_align_grouped  # noqa: F401
from mask_rcnn_tpu_torch.ops.roi_align import roi_pool  # noqa: F401
