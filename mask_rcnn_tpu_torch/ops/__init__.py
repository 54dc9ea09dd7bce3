"""Ops: boxes, anchors, NMS (kernels K2, K3) and RoIAlign (K1)."""
