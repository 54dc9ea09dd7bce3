"""Ops: boxes, anchors, losses, NMS (kernels K2, K3), the RoI poolers
(RoIAlign grouped K1/K7 and flat K4/K13, crop-and-resize K5/K11, max RoI
pooling K6/K12), the target creators (K9a anchor targets, K9b proposal
targets with the mask crop-resize K8) and the per-channel affine.

The flat names are the JAX package's (``mask_rcnn_tpu/ops/__init__.py``)
but one: ``ops.roi_align`` stays the module, since the port's own code
imports it as such; the flat RoIAlign is ``ops.roi_align.roi_align``."""

from mask_rcnn_tpu_torch.ops.boxes import bbox2loc  # noqa: F401
from mask_rcnn_tpu_torch.ops.boxes import bbox_iou  # noqa: F401
from mask_rcnn_tpu_torch.ops.boxes import clip_boxes  # noqa: F401
from mask_rcnn_tpu_torch.ops.boxes import loc2bbox  # noqa: F401
from mask_rcnn_tpu_torch.ops.anchors import enumerate_shifted_anchors  # noqa
from mask_rcnn_tpu_torch.ops.anchors import generate_anchor_base  # noqa
from mask_rcnn_tpu_torch.ops.nms import nms_padded  # noqa: F401
from mask_rcnn_tpu_torch.ops.roi_align import crop_and_resize  # noqa: F401
from mask_rcnn_tpu_torch.ops.roi_align import roi_align_grouped  # noqa: F401
from mask_rcnn_tpu_torch.ops.roi_align import roi_pool  # noqa: F401
from mask_rcnn_tpu_torch.ops.losses import sigmoid_cross_entropy  # noqa
from mask_rcnn_tpu_torch.ops.losses import smooth_l1_loss  # noqa: F401
from mask_rcnn_tpu_torch.ops.losses import softmax_cross_entropy  # noqa
from mask_rcnn_tpu_torch.ops.affine_channel import affine_channel  # noqa
from mask_rcnn_tpu_torch.ops.affine_channel import fold_batch_norm  # noqa
from mask_rcnn_tpu_torch.ops.affine_channel import (  # noqa: F401
    init_affine_channel,
)
