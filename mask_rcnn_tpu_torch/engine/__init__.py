"""Engine: optimizer, schedule and train step, with the JAX package's flat
names (``mask_rcnn_tpu/engine/__init__.py``); the driver is
``engine.loop.train``, the evaluation hooks ``engine.evaluator``."""

from mask_rcnn_tpu_torch.engine.trainer import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    step_lr_schedule,
    trainable_mask,
)
