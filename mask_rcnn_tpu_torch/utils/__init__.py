"""Host utilities, with the flat surface of ``mask_rcnn_tpu/utils`` (the
reference package's ``chainer_mask_rcnn.utils`` re-exports), so migrating
code can keep its import sites. Importing it imports neither cv2 nor the
host evaluator's C++ (built at its first use)."""

from mask_rcnn_tpu_torch.utils.checkpoint import load_params  # noqa: F401
from mask_rcnn_tpu_torch.utils.checkpoint import save_params  # noqa: F401
from mask_rcnn_tpu_torch.utils.masks import paste_masks  # noqa: F401

from mask_rcnn_tpu_torch.utils._itertools import batch  # noqa: F401
from mask_rcnn_tpu_torch.utils.logging import git_hash  # noqa: F401

from mask_rcnn_tpu_torch.utils.voc_eval import eval_instseg_voc  # noqa
from mask_rcnn_tpu_torch.utils.cocoeval import eval_instseg_coco  # noqa

from mask_rcnn_tpu_torch.utils.geometry import (  # noqa: F401
    get_bbox_overlap,
    get_mask_overlap,
    instance_boxes2label,
    label2instance_boxes,
    mask_to_bbox,
)

from mask_rcnn_tpu_torch.utils.visualizations import (  # noqa: F401
    draw_instance_bboxes,
    draw_instance_boxes,
    get_tile_image,
    label_colormap,
    visualize_instance_segmentation,
)
