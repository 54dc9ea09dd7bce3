"""mask_rcnn_tpu_torch: the PyTorch and CUDA port of ``mask_rcnn_tpu``.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``utils/``, ``data/``, ``engine/``, ``parallel/``) and its parameter
names, imports ``torch`` and numpy only (cv2, PIL, pyyaml and scipy
lazily, where a file format needs them), and runs the R-50/101-C4
inference path, the train step, the training driver
(``engine/loop.py::train``), data parallelism over ``torch.distributed``
(one process per device) and the entry points from disk: pretrained
weights (``pretrained_model``), the COCO, VOC and SBD datasets, and the
train and evaluate drivers (``examples/``). Its hand-written CUDA
kernels (``csrc/``: the fused stem, RoIAlign on grouped and flat rois
forward and backward, crop-and-resize and max RoI pooling forward and
backward, proposal NMS, per-class decode NMS, anchor/proposal matching,
mask-target crop-resize) are built with nvcc at first use on a GPU; on
CPU tensors every op runs its plain torch version.
"""

__version__ = "0.2.0"

from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet  # noqa: F401
from mask_rcnn_tpu_torch.models.mask_rcnn import (  # noqa: F401
    MaskRCNNConfig,
    init_params,
    predict_step,
)
from mask_rcnn_tpu_torch.models.rpn import ProposalConfig  # noqa: F401
from mask_rcnn_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_train_batch,
)
from mask_rcnn_tpu_torch.models.train_model import train_loss  # noqa: F401
from mask_rcnn_tpu_torch.engine.trainer import (  # noqa: F401
    create_train_state,
    make_optimizer,
    make_train_step,
)
