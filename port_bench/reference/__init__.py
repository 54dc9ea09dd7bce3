"""The plain reference that decides ``correct``: Mask R-CNN R-50/101-C4 in
plain PyTorch, float32 with TF32 off, written from the published model
(Detectron's C4 Mask R-CNN as chainer-mask-rcnn reproduces it) with frozen
copies of plain code where the semantics are fiddly (cv2's bilinear resize,
Detectron's mask paste, chainercv's target creators). It imports neither
``jax`` nor either Mask R-CNN package, and takes nothing that the program
made: the benchmark hands both sides the same raw images, weights and
sampling priorities.

* :mod:`.model`: preparation, backbone, RPN, proposals, RoIAlign, the C4
  head, the decode and the paste;
* :mod:`.train`: the target creators, the five losses and the optimizer.

``Precision(fp8=True)`` computes every convolution and matrix product on
operands rounded to float8 (e4m3, scaled per tensor): the control that the
comparison has to fail.
"""
