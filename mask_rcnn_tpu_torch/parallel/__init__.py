"""Data parallelism over ``torch.distributed`` (one process per device),
the port of ``mask_rcnn_tpu/parallel``."""

from mask_rcnn_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    all_reduce_grads,
    barrier,
    broadcast_params,
    destroy_distributed,
    init_distributed,
    is_distributed,
    local_batch_slice,
    make_parallel_predict_step,
    make_parallel_train_step,
    process_count,
    process_index,
    process_zero,
    replicate_params,
)
