"""Models: ResNet-C4 backbone, RPN, RoI head, predict step, API, target
creators and the train loss, with the JAX package's flat names
(``mask_rcnn_tpu/models/__init__.py``)."""

from mask_rcnn_tpu_torch.models.api import MaskRCNNResNet  # noqa: F401
from mask_rcnn_tpu_torch.models.mask_rcnn import MaskRCNNConfig  # noqa
from mask_rcnn_tpu_torch.models.mask_rcnn import init_params  # noqa: F401
from mask_rcnn_tpu_torch.models.mask_rcnn import predict_step  # noqa: F401
from mask_rcnn_tpu_torch.models.rpn import ProposalConfig  # noqa: F401
from mask_rcnn_tpu_torch.models.targets import (  # noqa: F401
    AnchorTargetConfig,
    ProposalTargetConfig,
    anchor_targets,
    proposal_targets,
)
from mask_rcnn_tpu_torch.models.train_model import train_loss  # noqa: F401
