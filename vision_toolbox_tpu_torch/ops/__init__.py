"""Ops: the fused half-block kernels (K3, K4, forward and backward), the
three-shear warp (K1), talking-head (K5) and flash (K6) attention, the
augmentations and the attention core."""
