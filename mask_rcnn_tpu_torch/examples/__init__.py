"""Command-line tools, the port of the JAX package's ``examples/``: train
and evaluate on COCO (``examples.coco``), VOC/SBD (``examples.voc``) and a
directory of images with label images (``examples.custom_dataset``), the
demos (``<dataset>.demo``), ``coco.speedtest``, ``coco.convert_caffe2``,
``<coco|voc>.download_datasets``, ``view_dataset``, ``summarize_logs``,
the rehearsals (``check_coco_rehearsal``, ``check_voc_rehearsal``) and
the overfit checks (``check_train_overfit``, ``check_overfit_map``), the
profiling tools on ``utils/profiling.py`` (``mfu_report``,
``train_profile``, ``head_profile``, ``bench_align_variants``) and the
last two checks (``check_eval_memory``, ``check_dtype_parity``). Each
runs as ``python -m mask_rcnn_tpu_torch.examples.<name>`` and is callable
as ``main(argv)``."""
