"""Command-line drivers, the port of the JAX package's ``examples/``:
train and evaluate on COCO (``examples.coco``), VOC/SBD
(``examples.voc``) and a directory of images with label images
(``examples.custom_dataset``), each runnable as
``python -m mask_rcnn_tpu_torch.examples.<dataset>.<train|evaluate>`` and
callable as ``main(argv)``. Visualization (``VisReport``, the demos) comes
in a later slice."""
