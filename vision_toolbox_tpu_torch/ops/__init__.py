"""Ops: the fused half-block kernels (K3, K4, forward and backward), the
three-shear warp (K1), short (K2), talking-head (K5), flash (K6) and
window (K7) attention, the shifted-window relayout (K8), the depthwise conv
(K9), the augmentations and the attention core."""
