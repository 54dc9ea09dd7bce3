"""mask_rcnn_tpu_torch: the PyTorch and CUDA port of ``mask_rcnn_tpu``.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``utils/``, ``data/``) and its parameter names, imports ``torch`` and numpy
only, and runs the R-50/101-C4 inference path. Its hand-written CUDA
kernels (``csrc/``: RoIAlign, proposal NMS, per-class decode NMS) are
built with nvcc at first use on a GPU; on CPU tensors every op runs its
plain torch version.
"""

__version__ = "0.1.0"

from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet  # noqa: F401
from mask_rcnn_tpu_torch.models.mask_rcnn import (  # noqa: F401
    MaskRCNNConfig,
    init_params,
    predict_step,
)
from mask_rcnn_tpu_torch.models.rpn import ProposalConfig  # noqa: F401
