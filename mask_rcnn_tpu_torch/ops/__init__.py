"""Ops: boxes, anchors, losses, NMS (kernels K2, K3), RoIAlign (K1, K7)
and the target creators' matching and mask crop-resize (K9, K8)."""
